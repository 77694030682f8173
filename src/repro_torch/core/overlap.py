"""Transfer-vs-compute overlap ledger (the port of
`repro.core.overlap.overlap_report`, for the data feed's
`stall_report`).

Where the rest of the reference module went:

* `with_sharding`, `shard_batch` and `shard_batch_tree` do not apply:
  each rank's block is made explicitly (`cluster/cells.build_cell`,
  `core/addressing.LeafShard`), and no compiler picks a layout;
* `prefetchable_scan` is the layer loop of `models/steps.forward` with
  `_remat` (`torch.utils.checkpoint` a layer);
* `_policy`'s names are cfg.remat's: `"nothing"` and no checkpoint
  (`"none"`, `"everything"`) in `models/steps._layer`, the selective
  `"dots"` / `"dots_no_batch"` in `core/remat.py`;
* the next layer's prefetch under the per-layer gather (`fsdp_gather`:
  each layer's all_gather sits on its critical path) is an open note of
  ROADMAP Queue 1.
"""

from __future__ import annotations


def overlap_report(produce_s: float, consumer_wait_s: float) -> dict:
    """`produce_s`: total producer busy seconds; `consumer_wait_s`: total
    seconds the consumer blocked on the feed. The difference is the
    transfer time that rode under compute; `overlap_pct` is the share of
    transfer hidden (100% = fully double-buffered, 0% = serial)."""
    hidden = max(produce_s - consumer_wait_s, 0.0)
    return {
        "produce_s": produce_s,
        "consumer_wait_s": consumer_wait_s,
        "hidden_s": hidden,
        "overlap_pct": 100.0 * hidden / produce_s if produce_s > 0 else 0.0,
    }
