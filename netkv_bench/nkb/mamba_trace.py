"""The Mamba mixers of the port's prefills as the program's own spans show
them.

A prefill records ``prefill.run`` (a = its prompt's tokens) around its
forward and first token's read, and inside it a ``layer.mamba`` span a Mamba
block (``repro_torch.hosttrace``), while a ``torch.profiler`` session
records, so a traced run's stretch holds the spans of the prefills that ran
inside it.  A program whose recorder has neither name, or a model with no
Mamba block, gives None, and the metric is left out.
"""

from __future__ import annotations

from . import program_trace


def mamba_prefill_ms(run):
    """Over each complete ``prefill.run`` span inside the traced stretch that
    holds ``layer.mamba`` spans: their summed host time per 1,000 of its
    prompt's tokens, ms; the mean over those prefills.  None where the
    stretch holds no such prefill."""
    ht, stretch = program_trace._hosttrace(), run.rec.stretch
    prefill, mamba = getattr(ht, "PREFILL", None), getattr(ht, "MAMBA", None)
    rec = ht.last_profiled() if prefill is not None and mamba is not None else None
    if rec is None or stretch is None or stretch.t_on is None or stretch.t_off is None:
        return None
    lo_ns, hi_ns = stretch.perf_on * 1e9, (run.rec.t0 + stretch.t_off) * 1e9
    mixed: dict[int, int] = {}
    for j, p in enumerate(rec.parent):
        if p >= 0 and rec.name[j] == mamba and rec.t1[j] >= 0:
            mixed[p] = mixed.get(p, 0) + rec.t1[j] - rec.t0[j]
    per_k = [mixed[i] / 1e6 / rec.a[i] * 1e3 for i in mixed
             if rec.name[i] == prefill and rec.parent[i] == -1 and rec.t1[i] >= 0
             and lo_ns <= rec.t0[i] and rec.t1[i] <= hi_ns and rec.a[i] > 0]
    return sum(per_k) / len(per_k) if per_k else None
