"""Tokens of every train step completed in the window, over the window."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return ctx["tokens"] / ctx["window_s"]
