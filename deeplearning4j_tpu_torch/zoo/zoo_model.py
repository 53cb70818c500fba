"""Model zoo base: ``ZooModel``, its metadata, pretrained weights from a
local artifact, and ``ModelSelector``.

Counterpart of ``deeplearning4j_tpu/zoo/zoo_model.py`` (DL4J's
``ZooModel.java``, ``ModelMetaData.java``, ``ModelSelector.java``).
``init(device=None)`` builds the model's network on ``cuda``
(``device="cpu"`` for the CPU). ``init_pretrained`` resolves the cached
artifact (``$DL4J_TPU_ZOO_DIR/<model>_<type>.zip``), fetching a registered
URL into the cache on a miss (a ``file://`` URL takes the same path),
verifies its Adler32 and SHA-256 where they apply, and restores it through
the port's readers: the reference's zip (``util/model_serializer.py``)
and DL4J's ModelSerializer zip (``modelimport/dl4j.py``). A download that
fails its check is deleted; a file the user placed is never deleted.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple, Type

@dataclasses.dataclass(frozen=True)
class ModelMetaData:
    """Shape metadata (reference ``ZooModel.metaData()``)."""

    input_shape: Tuple[Tuple[int, ...], ...]  # per graph input, CHW order like DL4J
    n_outputs: int = 1
    network_type: str = "cnn"  # "cnn" | "rnn"

    @property
    def use_mds(self) -> bool:
        return len(self.input_shape) > 1 or self.n_outputs > 1


class PretrainedType:
    IMAGENET = "imagenet"
    MNIST = "mnist"
    CIFAR10 = "cifar10"
    VGGFACE = "vggface"


class ZooModel:
    """Base class for zoo architectures (``ZooModel.java``).

    Subclasses implement ``conf()`` (a MultiLayerConfiguration or
    ComputationGraphConfiguration) and ``meta_data()``; ``init()`` builds and
    initializes the runtime network.
    """

    def __init__(self, num_labels: int = 1000, seed: int = 123):
        self.num_labels = num_labels
        self.seed = seed

    # -- to implement ------------------------------------------------------
    def conf(self):
        raise NotImplementedError

    def meta_data(self) -> ModelMetaData:
        raise NotImplementedError

    # -- common ------------------------------------------------------------
    def init(self, device=None):
        """The initialized network (seeded with this model's seed): a
        configuration built with ``list()`` becomes a ``MultiLayerNetwork``,
        one built with ``graph_builder()`` a ``ComputationGraph``."""
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import ComputationGraphConfiguration
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        c = self.conf()
        if isinstance(c, ComputationGraphConfiguration):
            return ComputationGraph(c, device=device).init(seed=self.seed)
        return MultiLayerNetwork(c, device=device).init(seed=self.seed)

    def _artifact_name(self, pretrained_type: str) -> str:
        """Cache-slot file name; models whose artifact varies beyond
        (class, type) — e.g. Darknet19's resolution-dependent weights —
        must extend this so distinct artifacts get distinct slots."""
        return f"{type(self).__name__.lower()}_{pretrained_type}.zip"

    def _cache_path(self, pretrained_type: str) -> str:
        root = os.environ.get("DL4J_TPU_ZOO_DIR",
                              os.path.expanduser("~/.deeplearning4j_tpu/zoo"))
        return os.path.join(root, self._artifact_name(pretrained_type))

    def pretrained_checkpoint(self, pretrained_type: str = PretrainedType.IMAGENET) -> Optional[str]:
        """Local cache path to pretrained weights, or None if absent.

        The reference's cache is ``~/.deeplearning4j/models`` filled by its
        downloader (``ZooModel.java:51-69``); ours is
        ``$DL4J_TPU_ZOO_DIR/<model>_<type>.zip``, filled either by the user
        or by :meth:`init_pretrained` fetching a registered URL.
        """
        p = self._cache_path(pretrained_type)
        return p if os.path.exists(p) else None

    #: subclasses/users may register weight-artifact URLs per pretrained
    #: type (``ZooModel.pretrainedUrl``; the reference points these at
    #: ``blob.deeplearning4j.org``). ``file://`` URLs work identically —
    #: the transport below is scheme-agnostic urllib.
    PRETRAINED_URLS: Dict[str, str] = {}

    def pretrained_url(self, pretrained_type: str) -> Optional[str]:
        return self.PRETRAINED_URLS.get(pretrained_type)

    #: subclasses/users may register expected Adler32 checksums per
    #: pretrained type (``ZooModel.pretrainedChecksum``; 0 = don't verify).
    #: NOTE the integrity limitation inherited from the reference: its blob
    #: store is plain http and Adler32 is not cryptographic, so this check
    #: catches corruption, not tampering. Register a SHA-256 in
    #: :attr:`PRETRAINED_SHA256` for tamper-evident verification.
    PRETRAINED_CHECKSUMS: Dict[str, int] = {}

    def pretrained_checksum(self, pretrained_type: str) -> int:
        return int(self.PRETRAINED_CHECKSUMS.get(pretrained_type, 0))

    #: optional cryptographic digests per pretrained type (hex SHA-256;
    #: beyond the reference, which verifies Adler32 only). Verified under
    #: the same provenance rule as the Adler32 registry.
    PRETRAINED_SHA256: Dict[str, str] = {}

    def pretrained_sha256(self, pretrained_type: str) -> str:
        return str(self.PRETRAINED_SHA256.get(pretrained_type, ""))

    def init_pretrained(self, pretrained_type: str = PretrainedType.IMAGENET,
                        expected_checksum: Optional[int] = None, device=None):
        """Build this architecture carrying pretrained weights
        (``ZooModel.initPretrained``, ``ZooModel.java:51-93``): resolve the
        cached artifact, verify its Adler32 checksum when one is expected,
        then restore through the FULL checkpoint reader — both this
        framework's own zips and the reference's DL4J ModelSerializer zips
        (``coefficients.bin`` + ``updaterState.bin``) load, for
        MultiLayerNetwork and ComputationGraph alike.

        A cache miss with a registered URL (:attr:`PRETRAINED_URLS`)
        triggers a fetch into the cache first — ``file://`` URLs exercise
        the identical transport/cache/checksum path as HTTP. Provenance
        decides what the registry checksum applies to: artifacts the
        fetcher wrote (marked with a ``.src`` sidecar) verify against the
        registered checksum on EVERY load, like the reference's cache; a
        user-placed file is their own choice of weights and only verifies
        when an explicit ``expected_checksum`` is passed. On mismatch, the
        artifact THIS call downloaded is deleted (``ZooModel.java:75-81``,
        so the next call re-fetches); any pre-existing file — even a
        marked cache the user may have replaced — is never deleted, the
        error explains how to recover instead."""
        import zipfile
        import zlib

        path = self.pretrained_checkpoint(pretrained_type)
        downloaded = False
        if path is None:
            url = self.pretrained_url(pretrained_type)
            if url is None:
                raise FileNotFoundError(
                    f"No pretrained weights for {type(self).__name__} ({pretrained_type}); "
                    f"place a checkpoint under $DL4J_TPU_ZOO_DIR or register "
                    f"a PRETRAINED_URLS entry to enable.")
            path = self._fetch(url, self._cache_path(pretrained_type))
            downloaded = True
        fetched = downloaded or os.path.exists(path + ".src")
        if expected_checksum is not None:
            expected = int(expected_checksum)
        else:
            expected = self.pretrained_checksum(pretrained_type) if fetched else 0
        expected_sha = self.pretrained_sha256(pretrained_type) if fetched else ""

        def fail(kind, got, want):
            if downloaded:
                # ZooModel.java:75-81: a corrupt download is removed so
                # the next attempt re-fetches instead of failing forever.
                # Only a file THIS call wrote is ever deleted — a slot
                # the user may have touched since a past fetch is not.
                os.remove(path)
                if os.path.exists(path + ".src"):
                    os.remove(path + ".src")
                raise ValueError(
                    f"Pretrained model file failed checksum: fetched "
                    f"{kind} {got}, expecting {want} ({path}); "
                    "the corrupt download was deleted — retry.")
            if fetched:
                raise ValueError(
                    f"Pretrained model file failed checksum: cached "
                    f"{kind} {got}, expecting {want} ({path}). "
                    "If the cache rotted, delete the file and its .src "
                    "marker to re-fetch; if you placed your own weights "
                    "in this slot, delete just the .src marker.")
            raise ValueError(
                f"Pretrained model file failed checksum: local {kind} "
                f"{got}, expecting {want} ({path}); the file is "
                "left in place — replace it with an intact copy.")

        if expected != 0 or expected_sha:
            import hashlib
            adler = 1  # zlib.adler32 seed, matches java.util.zip.Adler32
            # hash only when a digest is registered — the Adler-only common
            # case must not pay a discarded SHA-256 pass per load
            sha = hashlib.sha256() if expected_sha else None
            with open(path, "rb") as fh:
                for chunk in iter(lambda: fh.read(1 << 20), b""):
                    adler = zlib.adler32(chunk, adler)
                    if sha is not None:
                        sha.update(chunk)
            if expected != 0 and adler != expected:
                fail("Adler32", adler, expected)
            # the cryptographic check (when a digest is registered): the
            # Adler32-over-http path alone is corruption detection, not
            # tamper evidence
            if sha is not None and sha.hexdigest() != expected_sha.lower():
                fail("SHA-256", sha.hexdigest(), expected_sha.lower())
        with zipfile.ZipFile(path) as z:
            names = set(z.namelist())
        if "coefficients.bin" in names:  # reference DL4J ModelSerializer zip
            import json as _json
            from deeplearning4j_tpu_torch.modelimport.dl4j import (
                restore_computation_graph, restore_multi_layer_network)
            with zipfile.ZipFile(path) as z:
                raw = z.read("configuration.json").decode("utf-8")
            if "vertices" in _json.loads(raw):
                return restore_computation_graph(path, device=device)
            return restore_multi_layer_network(path, device=device)
        from deeplearning4j_tpu_torch.util.model_serializer import restore_model
        return restore_model(path, device=device)

    @staticmethod
    def _fetch(url: str, dest: str) -> str:
        """Stream ``url`` into ``dest`` (the cache slot) atomically: bytes
        land in ``dest + '.part'`` first so an interrupted transfer never
        poses as a finished artifact. Scheme-agnostic — ``file://`` and
        ``http(s)://`` share the path (``ZooModel.java:63-66``'s
        ``FileUtils.copyURLToFile`` role)."""
        import shutil
        import urllib.request

        os.makedirs(os.path.dirname(dest), exist_ok=True)
        part = dest + ".part"
        try:
            with urllib.request.urlopen(url) as resp, open(part, "wb") as out:
                shutil.copyfileobj(resp, out)
            # provenance marker BEFORE installing the artifact: a crash
            # between the two steps then leaves a marker with no artifact
            # (harmless — the next call re-fetches and rewrites it), never
            # a fetched artifact without a marker, which would dodge the
            # registry checksum on every later load
            with open(dest + ".src", "w") as fh:
                fh.write(url)
            os.replace(part, dest)
        finally:
            if os.path.exists(part):
                # failed mid-fetch: remove the orphan marker too, so a file
                # the USER later places in the slot is not misattributed to
                # the fetcher (and wrongly checksum-gated)
                os.remove(part)
                if os.path.exists(dest + ".src") and not os.path.exists(dest):
                    os.remove(dest + ".src")
        return dest


_ZOO_REGISTRY: Dict[str, Type[ZooModel]] = {}


def register_zoo_model(cls: Type[ZooModel]) -> Type[ZooModel]:
    _ZOO_REGISTRY[cls.__name__.lower()] = cls
    return cls


class ModelSelector:
    """Instantiate zoo models by name (reference ``ModelSelector.java``)."""

    @staticmethod
    def available() -> Sequence[str]:
        return sorted(_ZOO_REGISTRY)

    @staticmethod
    def select(name: str, num_labels: int = 1000, seed: int = 123) -> ZooModel:
        key = name.lower()
        if key not in _ZOO_REGISTRY:
            raise KeyError(f"Unknown zoo model {name!r}; available: {ModelSelector.available()}")
        return _ZOO_REGISTRY[key](num_labels=num_labels, seed=seed)
