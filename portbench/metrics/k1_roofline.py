"""K1 (``hist_multi``, one launch a step) against its bandwidth bound:
summed least time of the window's steps over their summed device time."""

from portbench.lib import roofline, stepbytes


def read(ctx):
    cap, s = ctx.capture, ctx.system
    ns = cap.by_name("hist_multi") if cap is not None else 0
    if not ns or not getattr(s, "window_steps", None):
        return None
    sb = stepbytes.of_stream(s, "cuda")
    total = sum(roofline.k1_bytes(*sb.k1(s.order[k], k))
                for k in s.window_steps)
    return roofline.share(total, ns / 1e9, ctx.card)
