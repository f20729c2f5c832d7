"""chain_ms: mean host milliseconds of one keyframe-chain dispatch
(System._dispatch_kf_chain; BatchedMapper.process) over the chains of the
traced window."""


def read(rec):
    spans = rec.get("spans", {}).get("chain", [])
    return sum(e - s for s, e in spans) / 1e6 / len(spans) if spans else None
