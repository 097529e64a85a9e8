"""Pool segments that shipped a started stream nothing: of the ``chunk``
records (one per streaming row and segment, a finished row's tail
included) of rows that had shipped audio by then, the share with 0 frames,
in the traced stretch; in percent. A row held past its last stable frame
(the margin withheld until the row ends) counts a miss at every segment it
waits. None without such a record."""

from perfbench.lib import spans as S


def read(ctx):
    rec = S.recorded(ctx)
    if rec is None:
        return None
    started = [c["attrs"] for c in S.inside(rec, "chunk") if c["attrs"]["emitted"] > 0]
    if not started:
        return None
    return 100.0 * sum(1 for a in started if a["frames"] == 0) / len(started)
