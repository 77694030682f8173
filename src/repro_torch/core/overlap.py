"""Transfer-vs-compute overlap ledger (the port of
`repro.core.overlap.overlap_report`, for the data feed's
`stall_report`). The rest of the reference module (layer scans with
remat, sharding constraints) is XLA's: ROADMAP Queue 1 K2."""

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
