"""peer_gib.index4: bytes moved between cards in one build of both
directions (each exchange's pieces sent to another card, and the rank
writes of each numbering into another card's table), from the program's
count (`dist_build.build_stats`) over the window, in GiB.  The count adds
the bytes of every pair of cards; None where the window ran no distributed
build."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("builds") or "peer_bytes" not in c:
        return None
    return c["peer_bytes"] / ctx["units"] / 2**30
