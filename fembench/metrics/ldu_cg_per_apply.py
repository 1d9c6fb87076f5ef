"""Inner CG iterations per block-LDU apply over the traced window: the two
A-solves' and the Sigma-CG's, from the counters of the direction's
``multigrid.PGSchurGMG`` (``ldu_a_cg_iters``, ``ldu_sigma_cg_iters``,
``ldu_applies``)."""


def read(rec):
    c = rec.counters
    applies = sum(c.get("ldu_applies", []))
    if not applies:
        return None
    return (sum(c.get("ldu_a_cg_iters", []))
            + sum(c.get("ldu_sigma_cg_iters", []))) / applies
