"""The decode engine's CUDA graphs as the program's own spans show them.

A replayed decode step records a ``decode.graph`` span inside its
``decode.enqueue`` (``repro_torch.hosttrace``, ``models/decode_graph.py``);
an eager step records its layers there instead.  Built on
``nkb.program_trace.analyze``, which keeps the traced stretch's complete
steps; a program whose recorder has no ``decode.graph`` name gives None,
and the metric is left out.
"""

from __future__ import annotations

from . import program_trace


def decode_graph_pct(run):
    """Share of the traced stretch's ``decode.step`` spans whose enqueue
    holds a ``decode.graph`` span, %."""
    a = program_trace.analyze(run)
    if a is None:
        return None
    st = a["stretch"]
    graph = getattr(st.ht, "GRAPH", None)
    if graph is None:
        return None
    replayed = sum(any(st.rec.name[j] == graph for j in kids) for kids in st.layers)
    return 100.0 * replayed / len(st.steps)
