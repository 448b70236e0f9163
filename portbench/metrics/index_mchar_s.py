"""index_mchar_s: the read-text characters indexed in the window, both
directions a build, over the whole window, in millions a second (host
clock)."""


def read(ctx):
    chars = ctx["work"].get("text_chars")
    return None if chars is None else ctx["units"] * chars / ctx["window_s"] / 1e6
