"""Helpers the port's parity tests share (`test_torch_recurrent.py`,
`test_torch_vlm.py`, `test_torch_grads.py`, `test_torch_dp.py`):
parameters loaded into both packages (or the port's draw in the
reference's layout, `reference_tree`), decode caches cast to f32 on both
sides, a layer's cache leaves read from the reference's `sub{i}` /
`rem{i}` tree and from the port's groups, a session served to its end,
and the fast compile of a reference program."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.cluster.session import Cluster as JCluster
from repro.cluster.session import ServeSessionProgram as JSession
from repro.models import steps as jsteps
from repro_torch import weights
from repro_torch.models import steps as tsteps

# compiler options for a reference program compiled only to be compared
# with: without XLA's costly backend passes it compiles in about half
# the time and computes the same function
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def f32(t) -> np.ndarray:
    return t.to(torch.float32).numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def open_gates(jp, attn=0.7, ffn=-0.4):
    """The cross block's tanh gates are drawn as zeros, which would leave
    the block out of the model: set them to seeded-free constants."""
    def one(path, a):
        key = str(path[-1])
        if "gate_attn" in key:
            return jnp.full_like(a, attn)
        if "gate_ffn" in key:
            return jnp.full_like(a, ffn)
        return a
    return jax.tree_util.tree_map_with_path(one, jp)


def true_fan_in(jp):
    """`ParamSpec` draws a 3-D weight with fan-in shape[-2]: wq, wk, wv
    (d, H, hd) with H, wo (H, hd, d) with hd. Without a qk-norm the random
    attention scores are then ~sqrt(d / H) times too large and each
    softmax picks one key, so that a sum order's one-ulp difference
    flips which (the reference's whisper note). Rescaled to the true
    fan-in (d, and H * hd), both packages get well-conditioned weights."""
    def one(path, a):
        key = str(getattr(path[-1], "key", path[-1]))
        if key in ("wq", "wk", "wv", "wo") and a.ndim >= 3:
            fan, true = ((a.shape[-2], a.shape[-3]) if key != "wo"
                         else (a.shape[-2], a.shape[-3] * a.shape[-2]))
            return (a.astype(jnp.float32) * (fan / true) ** 0.5).astype(
                a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(one, jp)


def load(jp, dtype=None):
    """A reference parameter tree (cast to `dtype`) and the port's copy."""
    if dtype is not None:
        jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    return jp, weights.from_jax_params(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def params(jcfg, dtype=None, seed=0):
    return load(true_fan_in(open_gates(jsteps.init_params(
        jcfg, jax.random.PRNGKey(seed)))), dtype)


def f32_caches(jcfg, tcfg, B, clen):
    jc = jax.tree.map(lambda c: c.astype(jnp.float32),
                      jsteps.init_cache(jcfg, B, clen))
    tc = {k: v.float() for k, v in
          tsteps.init_cache(tcfg, B, clen, device="cpu").items()}
    return jc, tc


def ref_layer(jcfg, tree, i: int) -> dict:
    """Layer i's leaves in a reference cache or parameter tree (its
    stacked `sub{i}` groups and unstacked `rem{i}` layers)."""
    pattern, n_super, _ = jsteps.block_plan(jcfg)
    period = len(pattern)
    if i < n_super * period:
        return jax.tree.map(lambda v: v[i // period],
                            tree["blocks"][f"sub{i % period}"])
    return dict(tree["rem"][f"rem{i - n_super * period}"])


def port_layer(tcfg, tc, i: int) -> dict:
    keys, j = tsteps.layer_caches(tcfg)[i]
    return {k: tc[key][j] for k, key in keys.items()}


def decode_both(jcfg, tcfg, jp, tp, policy, *, L, steps, B=3, extra=None):
    """Feed B slots a 4-token prompt at per-slot positions (offsets 0, 2,
    5), then decode greedily; f32 caches on both sides. Returns both
    packages' tokens (B, steps) and caches."""
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, jcfg.vocab, (B, 4)).astype(np.int32)
    offs = np.array([0, 2, 5][:B])
    clen = tsteps.decode_cache_len(tcfg, L)
    assert clen == jsteps.decode_cache_len(jcfg, L)
    jc, tc = f32_caches(jcfg, tcfg, B, clen)
    jstep = jax.jit(jsteps.make_decode_step(jcfg, max_seq=L, policy=policy))
    tstep = tsteps.make_decode_step(tcfg, max_seq=L, policy=policy)
    jtok, ttok = jnp.asarray(prompt[:, :1]), torch.from_numpy(prompt[:, :1])
    jout, tout = [], []
    for t in range(steps):
        pos = offs + t
        if t < prompt.shape[1]:
            jtok = jnp.asarray(prompt[:, t:t + 1])
            ttok = torch.from_numpy(prompt[:, t:t + 1])
        jc, jtok = jstep(jp, jc, {"tokens": jtok,
                                  "pos": jnp.asarray(pos, jnp.int32)})
        tc, ttok = tstep(tp, tc, {"tokens": ttok,
                                  "pos": torch.from_numpy(pos)})
        jout.append(np.asarray(jtok)[:, 0])
        tout.append(ttok.numpy()[:, 0])
    return np.stack(jout, 1), np.stack(tout, 1), jc, tc


def session_params(arch, common):
    """The reference session's own parameters (gates opened), in f32, and
    the port's copy."""
    jp = JCluster(arch).compile(JSession(preempt=False, **common)
                                ).init_params()
    return load(true_fan_in(open_gates(jp)), jnp.float32)


def serve(prog, p, reqs):
    """Submit `reqs` [(prompt, max_new)] to a fresh session of `prog`,
    its cache cast to f32, and drain it: (token arrays, stats)."""
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


# ----------------------------------------------------------------------------
# the robustness layer: sessions of both packages driven by one script
# ----------------------------------------------------------------------------

TIMING_KEYS = ("stall", "ttft_ms", "latency_ms", "tokens_per_s", "restore_s",
               "journal_bytes")


def f32_state_factory(prog):
    """Make `prog` (either package's compiled session) build its session
    states with the cache cast to f32, for `open`, `recover_wedged` and
    `restore` alike (bf16 near-ties would part the packages)."""
    orig = prog._make_state

    def make():
        st = orig()
        cache = st["cache"]
        if isinstance(next(iter(cache.values())), torch.Tensor):
            st["cache"] = {k: v.float() for k, v in cache.items()}
            return st
        return dict(st, cache=jax.tree.map(
            lambda c: c.astype(jnp.float32), cache))

    prog._make_state = make
    return prog


def drive(sess, arrivals: dict, wedged=()):
    """Serve a script: `arrivals` maps a poll index to the requests
    [(prompt, max_new, klass)] submitted just before that poll. Polls
    until every arrival is in and the session is idle; a `wedged`
    exception is recorded and recovered from. Returns (events: per poll
    [(rid, tokens, done)] or "wedged", {rid: handle})."""
    events, handles, i = [], {}, 0
    last = max(arrivals, default=0)
    while i <= last or sess.busy:
        for prompt, n, klass in arrivals.get(i, ()):
            h = sess.submit(prompt, n, klass=klass)
            handles[h.id] = h
        i += 1
        try:
            evs = sess.poll()
        except wedged:
            events.append("wedged")
            sess.recover_wedged()
            continue
        events.append([(h.id, np.asarray(t).tolist(), bool(d))
                       for h, t, d in evs])
    return events, handles


def counters(stats):
    """`stats()` without its timings (wall clocks part the packages)."""
    if isinstance(stats, dict):
        return {k: counters(v) for k, v in stats.items()
                if k not in TIMING_KEYS}
    return stats


def key_set(stats, prefix=""):
    """Every key path of a stats dict."""
    out = set()
    for k, v in stats.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("by_kind",):
            out |= key_set(v, prefix + k + ".")
    return out


def reference_tree(cfg, params) -> dict:
    """The port's parameters as f32 numpy arrays in the reference's
    layout: each leaf at its plan key (`steps.param_plan_keys`), the
    stacked ones stacked in layer order, dict keys sorted."""
    tree, stacks = {}, {}

    def put(key, value):
        *path, last = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = value

    def walk(keys, leaf):
        if isinstance(keys, dict):
            for k in keys:
                walk(keys[k], leaf[k])
        elif isinstance(keys, list):
            for ks, lf in zip(keys, leaf):
                walk(ks, lf)
        elif keys[1]:                             # (key, stacked)
            stacks.setdefault(keys[0], []).append(leaf.float().numpy())
        else:
            put(keys[0], leaf.float().numpy())

    def ordered(node):                  # dict keys sorted, as jax's are
        if isinstance(node, dict):
            return {k: ordered(node[k]) for k in sorted(node)}
        return node

    walk(tsteps.param_plan_keys(cfg), params)
    for key, layers in stacks.items():
        put(key, np.stack(layers))
    return ordered(tree)
