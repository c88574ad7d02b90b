"""Share of the traced window in which no activity ran on the card."""


def read(ctx):
    cap = ctx.capture
    if cap is None or cap.window_ns() <= 0:
        return None
    return 100.0 * (1.0 - cap.busy_ns() / cap.window_ns())
