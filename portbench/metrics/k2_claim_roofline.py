"""K2's claim half (``arena_claim_*`` kernels) against its bandwidth
bound over the window's steps."""

from portbench.lib import roofline, stepbytes


def read(ctx):
    cap, s = ctx.capture, ctx.system
    ns = cap.by_name("arena_claim") if cap is not None else 0
    if not ns or not getattr(s, "window_steps", None):
        return None
    sb = stepbytes.of_stream(s)
    buckets = s.store.config.idx_layout[1]
    total = sum(roofline.k2_claim_bytes(sb.k2_rows(s.order[k]), buckets)
                for k in s.window_steps)
    return roofline.share(total, ns / 1e9, ctx.card)
