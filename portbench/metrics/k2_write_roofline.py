"""K2's write half (``arena_write_rows``) against its bandwidth bound
over the window's steps, each step's kept rows counted from its inputs."""

from portbench.lib import roofline, stepbytes


def read(ctx):
    cap, s = ctx.capture, ctx.system
    ns = cap.by_name("arena_write_rows") if cap is not None else 0
    if not ns or not getattr(s, "window_steps", None):
        return None
    sb = stepbytes.of_stream(s, "cuda")
    total = sum(roofline.k2_write_bytes(*sb.k2(s.order[k], k))
                for k in s.window_steps)
    return roofline.share(total, ns / 1e9, ctx.card)
