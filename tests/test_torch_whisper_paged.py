"""whisper through repro_torch's paged ServeSession against the
reference's, at smoke size.

`whisper-small-smoke` under ServeSessionProgram(paged=True): the decoder's
self K/V live in the shared page pool, its cross K/V stay private (zeros:
nothing fills them from an encoder in either package, ROADMAP Queue 3).
One request script, with a shared 8-token preamble (two 4-token pages)
and two identical page-aligned prompts, goes through both sessions. The
tokens of every request must be equal, and so must the pool counters.
Parameters and caches are cast to f32 on both sides, where no greedy
argmax sits near a tie.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.session import Cluster as JCluster
from repro.cluster.session import ServeSessionProgram as JProgram
from repro_torch import weights
from repro_torch.cluster.session import Cluster as TCluster
from repro_torch.cluster.session import ServeSessionProgram as TProgram

ARCH = "whisper-small-smoke"
COMMON = dict(slots=3, max_seq=32, max_prompt=12, chunk=4, paged=True,
              page_size=4)


def _script():
    rng = np.random.default_rng(1)
    pre = rng.integers(1, 200, 8).astype(np.int32)
    reqs = []
    for i in range(7):
        if i in (3, 6):                       # exact page cover: COW fork
            prompt = pre.copy()
        elif i % 2:
            prompt = np.concatenate([pre, rng.integers(1, 200, 2)])
        else:
            prompt = rng.integers(1, 200, int(rng.integers(2, 10)))
        reqs.append((prompt.astype(np.int32), int(rng.integers(3, 9))))
    return reqs


def _serve(prog, p, reqs):
    sess = prog.open(params=p)
    cache = sess.state["cache"]
    if isinstance(next(iter(cache.values())), torch.Tensor):
        sess.state["cache"] = {k: v.float() for k, v in cache.items()}
    else:
        sess.state = dict(sess.state, cache=jax.tree.map(
            lambda c: c.astype(jnp.float32), cache))
    handles = [sess.submit(prompt, n) for prompt, n in reqs]
    stats = sess.drain()
    return [h.result() for h in handles], stats


@pytest.mark.parametrize("policy", ["tuned", "fused"])
def test_whisper_paged_session_matches_reference(policy):
    jc, tc = JCluster(ARCH), TCluster(ARCH, device="cpu")
    with jc.policy(policy):
        jprog = jc.compile(JProgram(preempt=False, **COMMON))
    with tc.policy(policy):
        tprog = tc.compile(TProgram(**COMMON))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jprog.init_params())
    tp = weights.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    reqs = _script()
    jtoks, jst = _serve(jprog, jp, reqs)
    ttoks, tst = _serve(tprog, tp, reqs)
    for (prompt, n), a, b in zip(reqs, jtoks, ttoks):
        assert b.size == n
        np.testing.assert_array_equal(b, a)
    assert tst["kv"] == {k: jst["kv"][k] for k in tst["kv"]}
    assert tst["kv"]["prefix_hits"] > 0 and tst["kv"]["cow_forks"] > 0
    assert tst["requests_done"] == jst["requests_done"] == len(reqs)
