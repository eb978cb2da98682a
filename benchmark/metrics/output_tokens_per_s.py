"""Tokens the consumers received in the window, over the window, both
trimmed to whole engine rounds (``readers.whole_rounds``)."""

from benchmark import readers


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    tokens, seconds = readers.whole_rounds(ctx)
    return tokens / seconds if seconds else None
