"""Tab-delimited text serialisation of learned graph vectors.

Format parity with ``graph/models/loader/GraphVectorSerializer.java``:
one line per vertex — ``index<TAB>v0<TAB>v1...``; loading reconstructs a
:class:`GraphVectors` whose lookup table has no tree (inference only), exactly
like the reference's ``loadTxtVectors``.

The port's copy of the JAX package's ``graph/serializer.py``: the same
file, written from the table on any device (``repr`` of each f32 value, so
a file read back gives the table bit for bit); ``load_txt_vectors`` puts
the vectors on the card unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.graph.deepwalk import GraphVectors, InMemoryGraphLookupTable

_DELIM = "\t"


class GraphVectorSerializer:
    @staticmethod
    def write_graph_vectors(model: GraphVectors, path: str) -> None:
        vectors = model.lookup_table.get_vertex_vectors()  # one device read
        with open(path, "w", encoding="utf-8") as f:
            for i, vec in enumerate(vectors):
                f.write(str(i) + _DELIM
                        + _DELIM.join(repr(float(x)) for x in vec) + "\n")

    @staticmethod
    def load_txt_vectors(path: str, device=None) -> GraphVectors:
        rows = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split(_DELIM)
                if len(parts) > 1:
                    rows.append([float(x) for x in parts[1:]])
        if not rows:
            raise ValueError(f"No vectors found in {path!r}")
        arr = np.asarray(rows, dtype=np.float32)
        table = InMemoryGraphLookupTable(arr.shape[0], arr.shape[1], None, 0.01,
                                         device=device)
        table.set_vertex_vectors(arr)
        return GraphVectors(table)
