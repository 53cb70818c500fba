"""HDF5 archive reader for Keras files.

Counterpart of ``deeplearning4j_tpu/modelimport/keras/hdf5.py`` (DL4J's
``Hdf5Archive.java``, which wraps libhdf5 through JavaCPP): h5py reads the
files, imported only when an archive is opened, so the modules that import
this one load without h5py.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np


class Hdf5Archive:
    """Thin h5py wrapper matching Hdf5Archive's read API."""

    def __init__(self, path):
        import h5py
        self._f = h5py.File(path, "r")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    @staticmethod
    def _decode(v):
        if isinstance(v, bytes):
            return v.decode("utf-8")
        return v

    def read_attribute_as_string(self, name: str, *groups: str) -> Optional[str]:
        node = self._node(*groups)
        if name not in node.attrs:
            return None
        return self._decode(node.attrs[name])

    def read_attribute_as_json(self, name: str, *groups: str) -> Optional[dict]:
        s = self.read_attribute_as_string(name, *groups)
        return None if s is None else json.loads(s)

    def has_attribute(self, name: str, *groups: str) -> bool:
        return name in self._node(*groups).attrs

    def read_attribute_as_fixed_length_string_list(self, name: str, *groups: str) -> List[str]:
        node = self._node(*groups)
        if name not in node.attrs:
            return []
        return [self._decode(v) for v in node.attrs[name]]

    def read_dataset(self, name: str, *groups: str) -> np.ndarray:
        return np.asarray(self._node(*groups)[name])

    def get_data_sets(self, *groups: str) -> List[str]:
        import h5py
        node = self._node(*groups)
        return [k for k in node.keys() if isinstance(node[k], h5py.Dataset)]

    def get_groups(self, *groups: str) -> List[str]:
        import h5py
        node = self._node(*groups)
        return [k for k in node.keys() if isinstance(node[k], h5py.Group)]

    def _node(self, *groups: str):
        node = self._f
        for g in groups:
            node = node[g]
        return node


def read_weights_for_layer(archive: Hdf5Archive, layer_name: str,
                           *root: str) -> Dict[str, np.ndarray]:
    """Collect every dataset under the layer's weight group, flattened to
    ``{basename: array}`` (handles both Keras1 flat names and Keras2
    ``layer/variable:0`` nesting)."""
    out: Dict[str, np.ndarray] = {}

    _MHA_PROJ = {"query", "key", "value", "attention_output"}

    def walk(groups, prefix):
        for ds in archive.get_data_sets(*groups):
            base = prefix + ds.split(":")[0]
            out[base] = archive.read_dataset(ds, *groups)
        subs = archive.get_groups(*groups)
        # MultiHeadAttention nests its four projections as SIBLING groups;
        # require at least three of them together before treating the names
        # as MHA projections, so an ordinary layer named e.g. "value" keeps
        # flat basenames
        sub_bases = {s.split(":")[0] for s in subs}
        is_mha_level = len(_MHA_PROJ & sub_bases) >= 3
        for sub in subs:
            # Bidirectional wrappers encode direction in the group path
            # (forward_lstm/..., backward_lstm/...); MHA projections surface
            # as name prefixes so their basenames don't collide
            sub_prefix = prefix
            base = sub.split(":")[0]
            if sub.startswith("forward"):
                sub_prefix = "forward_"
            elif sub.startswith("backward"):
                sub_prefix = "backward_"
            elif is_mha_level and base in _MHA_PROJ:
                sub_prefix = prefix + base + "_"
            walk(list(groups) + [sub], sub_prefix)

    walk(list(root) + [layer_name], "")
    return out
