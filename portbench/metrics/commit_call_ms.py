"""Host ms a committed step spends in the store's commit call (the
harness's span around ``_commit_unit``), mean over the window."""


def read(ctx):
    spans = ctx.system.spans.spans.get("commit", [])
    if not spans:
        return None
    return sum(e - s for s, e, _ in spans) / len(spans) / 1e6
