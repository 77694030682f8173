"""Three faults of repro_torch's serving API against the reference's API.

* `RequestHandle.cancelled` and `.failed` (reference
  `runtime/scheduler.py`): a cancelled request reads cancelled, a request
  the page pool can never hold reads failed ("pool_exhausted").
* `Cluster.kernel_policy` and `Cluster.policy(**fields)` (reference
  `cluster/session.py`): a keyword scope builds a KernelPolicy, is the
  cluster's policy inside the block and is captured by `compile`; block
  overrides still raise (ROADMAP Queue 1 item 12).
* `ServeSession.poll`, `stream` and `drain` take `timeout_s`: None, or a
  bound the device meets, serves as before; a scripted wedge raises
  `SessionWedged` once the bound has passed.
"""

import numpy as np
import pytest

from repro.cluster.session import Cluster as JCluster
from repro_torch.cluster.policy import current_policy
from repro_torch.cluster.session import Cluster, ServeSessionProgram
from repro_torch.runtime import FaultPlan, SessionWedged

ARCH = "qwen3-14b-smoke"


def test_request_handle_reads_cancelled_and_failed():
    cluster = Cluster(ARCH, device="cpu")
    sess = cluster.compile(ServeSessionProgram(
        slots=2, max_seq=16, max_prompt=8, chunk=4)).open()
    queued = [sess.submit(np.arange(1, 4), 4) for _ in range(3)]
    assert sess.cancel(queued[2])
    sess.drain()
    assert queued[2].cancelled and not queued[2].failed
    assert queued[0].ok and not queued[0].cancelled and not queued[0].failed
    # a pool of 2 usable pages of 4 tokens cannot hold 12 positions
    paged = cluster.compile(ServeSessionProgram(
        slots=2, max_seq=16, max_prompt=8, chunk=4, paged=True, page_size=4,
        n_pages=3)).open()
    h = paged.submit(np.arange(1, 9), 5)
    paged.drain()
    assert h.failed and not h.cancelled and h.fail_reason == "pool_exhausted"


def test_cluster_kernel_policy_and_keyword_scopes():
    cluster = Cluster(ARCH, device="cpu")
    assert cluster.kernel_policy.mode == JCluster(ARCH).kernel_policy.mode
    with cluster.policy(mode="tuned",
                        overrides={"matmul": "reference"}) as pol:
        assert cluster.kernel_policy is pol and current_policy() is pol
        assert pol.mode_for("matmul") == "reference"
        assert pol.mode_for("rmsnorm") == "tuned"
        prog = cluster.compile(ServeSessionProgram(slots=2))
    assert prog.policy is pol
    assert cluster.kernel_policy.mode == "tuned" and \
        cluster.kernel_policy is not pol
    with cluster.policy("fused", overrides={"matmul": "interpret"}) as pol:
        assert pol.fused and pol.mode_for("matmul") == "interpret"
    # a pinned plan (the tuning layer): the policy takes it and
    # blocks_for returns it, as the reference's does
    with cluster.policy(mode="tuned",
                        overrides={"matmul": {"bm": 64}}) as pol:
        assert pol.blocks_for("matmul") == {"bm": 64}
        assert cluster.kernel_policy is pol
    with JCluster(ARCH).policy(mode="tuned",
                               overrides={"matmul": {"bm": 64}}) as jpol:
        assert jpol.blocks_for("matmul") == {"bm": 64}


def test_session_calls_take_timeout_s():
    prog = Cluster(ARCH, device="cpu").compile(ServeSessionProgram(
        slots=2, max_seq=16, max_prompt=8, chunk=4))
    sess = prog.open()
    h = sess.submit(np.arange(1, 4), 3)
    assert sess.poll(timeout_s=None) is not None
    for _ in sess.stream(timeout_s=None):
        pass
    assert sess.drain(timeout_s=None)["requests_done"] == 1 and h.ok
    # a bound the device meets serves as before, on each call
    h2 = sess.submit(np.arange(1, 4), 3)
    assert sess.poll(timeout_s=30.0) is not None
    for _ in sess.stream(timeout_s=30.0):
        pass
    assert sess.drain(timeout_s=30.0)["requests_done"] == 2
    np.testing.assert_array_equal(h2.result(), h.result())
    # a scripted wedge raises SessionWedged from each call, the
    # StallClock ledger attached, and the session recovers
    for call in (lambda s: s.poll(timeout_s=0.05),
                 lambda s: next(s.stream(timeout_s=0.05)),
                 lambda s: s.drain(timeout_s=0.05)):
        sess = prog.open(faults=FaultPlan().wedge(at_chunk=0))
        h = sess.submit(np.arange(1, 4), 3)
        with pytest.raises(SessionWedged) as e:
            call(sess)
        assert e.value.chunk == 0 and "host_syncs" in e.value.stall
        with pytest.raises(RuntimeError, match="wedged"):
            sess.poll()
        sess.recover_wedged()
        sess.drain(timeout_s=30.0)
        assert h.ok and h.result().tolist() == h2.result().tolist()
