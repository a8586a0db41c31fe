"""% of the window's coefficient sources whose coefficients the entropy
reader wrote straight into their own pinned wire slot (engine,
engine/processor.py `_read_into_slot`): /stats engine
100 × Δslot_reads / Δcoef_src. None where the server has no such
counter."""

from harness import spans


def read(run):
    return spans.ratio(run, ("engine", "slot_reads"), ("engine", "coef_src"),
                       100.0)
