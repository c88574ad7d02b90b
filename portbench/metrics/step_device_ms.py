"""Device ms a step: the union of the card's activities in the traced
window over the steps committed in it (the writer alone uses the card)."""


def read(ctx):
    cap, steps = ctx.capture, getattr(ctx.system, "window_steps", None)
    if cap is None or not steps:
        return None
    return cap.busy_ns() / len(steps) / 1e6
