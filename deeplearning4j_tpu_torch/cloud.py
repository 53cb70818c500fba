"""Cloud provisioning & storage: the reference's AWS module, TPU-native.

The reference ships `deeplearning4j-aws` (EC2 provisioning
`aws/ec2/provision/HostProvisioner.java`, S3 up/download, EMR). The
TPU-native equivalents are GCP: TPU-VM provisioning through ``gcloud`` and
object storage through GCS — with S3 kept for capability parity. Everything
is gated: command builders always work (and are unit-testable); execution
requires the respective CLI/SDK which this image does not bundle, and a
``file://`` scheme provides a local emulation path for tests.

The port's copy of the JAX package's jax-free ``cloud.py``
(``google.cloud`` and ``boto3`` are imported only when a gs:// or s3://
URI is used).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional
from urllib.parse import urlparse


class TpuProvisioner:
    """Builds (and optionally runs) ``gcloud compute tpus tpu-vm`` commands —
    the HostProvisioner role for TPU slices."""

    def __init__(self, project: str, zone: str, runner=None):
        self.project = project
        self.zone = zone
        self._runner = runner or self._run

    @staticmethod
    def _run(cmd: List[str]) -> str:
        if shutil.which(cmd[0]) is None:
            raise RuntimeError(
                f"{cmd[0]!r} CLI not available in this environment; use the "
                "returned command on a workstation with gcloud installed")
        return subprocess.run(cmd, check=True, capture_output=True,
                              text=True).stdout

    def create_command(self, name: str, accelerator_type: str = "v5p-8",
                       version: str = "tpu-ubuntu2204-base") -> List[str]:
        return ["gcloud", "compute", "tpus", "tpu-vm", "create", name,
                f"--project={self.project}", f"--zone={self.zone}",
                f"--accelerator-type={accelerator_type}",
                f"--version={version}"]

    def delete_command(self, name: str) -> List[str]:
        return ["gcloud", "compute", "tpus", "tpu-vm", "delete", name,
                f"--project={self.project}", f"--zone={self.zone}", "--quiet"]

    def ssh_command(self, name: str, command: str,
                    worker: str = "all") -> List[str]:
        return ["gcloud", "compute", "tpus", "tpu-vm", "ssh", name,
                f"--project={self.project}", f"--zone={self.zone}",
                f"--worker={worker}", f"--command={command}"]

    def run_command(self, cmd: List[str]) -> str:
        """Execute an arbitrary built command through the configured runner
        (the single dispatch point — inject a fake runner to test/log)."""
        return self._runner(cmd)

    def create(self, name: str, **kw) -> str:
        return self._runner(self.create_command(name, **kw))

    def delete(self, name: str) -> str:
        return self._runner(self.delete_command(name))

    def run_on(self, name: str, command: str, **kw) -> str:
        return self._runner(self.ssh_command(name, command, **kw))


class ObjectStorage:
    """Upload/download against gs:// (google-cloud-storage), s3://  (boto3),
    or file:// (always available — the test/emulation path). The reference's
    S3Uploader/S3Downloader role."""

    def upload(self, local_path: str, uri: str) -> None:
        scheme, bucket, key = self._parse(uri)
        if scheme == "file":
            dest = os.path.join(bucket, key.lstrip("/"))
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            shutil.copyfile(local_path, dest)
        elif scheme == "gs":
            client = self._gcs()
            client.bucket(bucket).blob(key.lstrip("/")).upload_from_filename(
                local_path)
        elif scheme == "s3":
            self._s3().upload_file(local_path, bucket, key.lstrip("/"))
        else:
            raise ValueError(f"unsupported scheme {scheme!r}")

    def download(self, uri: str, local_path: str) -> None:
        scheme, bucket, key = self._parse(uri)
        if scheme == "file":
            shutil.copyfile(os.path.join(bucket, key.lstrip("/")), local_path)
        elif scheme == "gs":
            client = self._gcs()
            client.bucket(bucket).blob(key.lstrip("/")).download_to_filename(
                local_path)
        elif scheme == "s3":
            self._s3().download_file(bucket, key.lstrip("/"), local_path)
        else:
            raise ValueError(f"unsupported scheme {scheme!r}")

    @staticmethod
    def _parse(uri: str):
        p = urlparse(uri)
        if p.scheme == "file":
            # file:///tmp/bucket/key → bucket=/tmp/bucket-part? keep it simple:
            # everything up to the last component is the "bucket" directory
            full = p.path
            return "file", os.path.dirname(full), os.path.basename(full)
        return p.scheme, p.netloc, p.path

    @staticmethod
    def _gcs():
        try:
            from google.cloud import storage
        except ImportError as e:
            raise ImportError("google-cloud-storage is not installed; "
                              "use file:// URIs for local staging") from e
        return storage.Client()

    @staticmethod
    def _s3():
        try:
            import boto3
        except ImportError as e:
            raise ImportError("boto3 is not installed; "
                              "use file:// URIs for local staging") from e
        return boto3.client("s3")


class HostProvisioner:
    """Per-host script staging + execution over the TPU-VM ssh/scp channel
    (``aws/ec2/provision/HostProvisioner.java`` role: ``uploadAndRun``,
    ``runRemoteCommand``, ``uploadForDeployment`` — JSch sessions become
    ``gcloud compute tpus tpu-vm ssh/scp`` invocations)."""

    def __init__(self, provisioner: TpuProvisioner, name: str,
                 worker: str = "all"):
        self.provisioner = provisioner
        self.name = name
        self.worker = worker

    def scp_command(self, local_path: str, remote_path: str) -> List[str]:
        p = self.provisioner
        return ["gcloud", "compute", "tpus", "tpu-vm", "scp", local_path,
                f"{self.name}:{remote_path}",
                f"--project={p.project}", f"--zone={p.zone}",
                f"--worker={self.worker}"]

    def upload_for_deployment(self, local_path: str, remote_path: str) -> str:
        """``uploadForDeployment``: stage a file on every worker."""
        return self.provisioner.run_command(
            self.scp_command(local_path, remote_path))

    def run_remote_command(self, command: str) -> str:
        return self.provisioner.run_on(self.name, command, worker=self.worker)

    def upload_and_run(self, script_path: str, root_dir: str = "/tmp") -> str:
        """``uploadAndRun``: stage a setup script and execute it.

        ``~``-rooted paths are staged via scp's native tilde handling and
        executed via ``$HOME`` inside double quotes (``shlex.quote`` would
        freeze the tilde as a literal)."""
        import posixpath
        import shlex
        remote = posixpath.join(root_dir, os.path.basename(script_path))
        self.upload_for_deployment(script_path, remote)
        if remote == "~" or remote.startswith("~/"):
            # "$HOME" expands; the rest stays shlex-quoted so metacharacters
            # in the basename can never execute remotely
            q = '"$HOME"' + (("/" + shlex.quote(remote[2:])) if len(remote) > 2
                             else "")
        else:
            q = shlex.quote(remote)
        return self.run_remote_command(f"chmod +x {q} && {q}")


class ClusterProvisioner:
    """Bring up N single-host TPU VMs (or one multi-host slice), wait until
    they are READY, provision them in parallel, tear them down — the
    ``Ec2BoxCreator`` + ``ClusterSetup`` orchestration
    (``ec2/provision/ClusterSetup.java``: create boxes, blockTillAllRunning,
    provision workers on a thread pool)."""

    def __init__(self, provisioner: TpuProvisioner, num_workers: int = 1,
                 accelerator_type: str = "v5p-8",
                 version: str = "tpu-ubuntu2204-base",
                 name_prefix: str = "dl4j-tpu"):
        self.provisioner = provisioner
        self.num_workers = num_workers
        self.accelerator_type = accelerator_type
        self.version = version
        self.name_prefix = name_prefix

    @property
    def names(self) -> List[str]:
        return [f"{self.name_prefix}-{i}" for i in range(self.num_workers)]

    def describe_command(self, name: str) -> List[str]:
        p = self.provisioner
        return ["gcloud", "compute", "tpus", "tpu-vm", "describe", name,
                f"--project={p.project}", f"--zone={p.zone}",
                "--format=value(state)"]

    def _pool(self):
        from concurrent.futures import ThreadPoolExecutor
        return ThreadPoolExecutor(max_workers=max(1, min(8, self.num_workers)))

    def create(self) -> List[str]:
        """Create every VM in parallel (``Ec2BoxCreator.create``; creation is
        the slowest step — minutes per node); returns the names."""
        if not self.names:
            return []
        with self._pool() as ex:
            list(ex.map(lambda n: self.provisioner.create(
                n, accelerator_type=self.accelerator_type,
                version=self.version), self.names))
        return self.names

    def block_till_all_running(self, poll_seconds: float = 10.0,
                               timeout: float = 900.0) -> None:
        """``blockTillAllRunning``: poll describe until every VM is READY."""
        import time as _time
        deadline = _time.monotonic() + timeout
        pending = list(self.names)
        while pending:
            still = []
            for name in pending:
                state = self.provisioner.run_command(
                    self.describe_command(name)).strip().upper()
                if state != "READY":
                    still.append(name)
            if not still:
                return
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"TPU VMs not READY within {timeout}s: {still}")
            _time.sleep(poll_seconds)
            pending = still

    def provision_workers(self, setup_script: str) -> List[str]:
        """Run the worker setup script on every VM in parallel
        (``ClusterSetup.provisionWorkers`` thread pool)."""
        if not self.names:
            return []
        def one(name):
            return HostProvisioner(self.provisioner, name).upload_and_run(
                setup_script)
        with self._pool() as ex:
            return list(ex.map(one, self.names))

    def teardown(self) -> None:
        """Delete every VM; per-VM failures are collected as warnings so a
        teardown after a PARTIAL create (some VMs never existed) still
        removes the ones that do, and never masks the original error."""
        if not self.names:
            return
        import warnings

        def one(name):
            try:
                self.provisioner.delete(name)
            except Exception as e:  # noqa: BLE001 - best-effort cleanup
                warnings.warn(f"teardown: could not delete {name}: {e}",
                              stacklevel=2)

        with self._pool() as ex:
            list(ex.map(one, self.names))


class BucketDataSetIterator:
    """Iterate serialized DataSets straight out of object storage
    (``s3/reader/BaseS3DataSetIterator.java`` + ``BucketIterator`` role).

    Keys are listed from the bucket URI (works with ``file://`` locally —
    the test/emulation path, like every storage entry point here), each
    object is fetched and deserialized with ``datasets.dataset.DataSet``'s
    npz layout (features/labels [+ masks])."""

    def __init__(self, bucket_uri: str, storage: Optional[ObjectStorage] = None,
                 suffix: str = ".npz"):
        self.bucket_uri = bucket_uri.rstrip("/")
        self.storage = storage or ObjectStorage()
        self.suffix = suffix
        self._keys = self.list_keys()
        self._pos = 0

    def _prefix(self):
        """(scheme, bucket, key_prefix) of the bucket URI itself. The prefix
        keeps its trailing '/' (when non-empty) so sibling prefixes like
        ``data-old/`` never match a ``data/`` listing."""
        from urllib.parse import urlparse
        p = urlparse(self.bucket_uri)
        prefix = p.path.lstrip("/")
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        return p.scheme, p.netloc, prefix

    def list_keys(self) -> List[str]:
        """Keys RELATIVE to the bucket URI (nested keys keep their
        subpath, so ``__next__`` re-joins to a real object URI)."""
        scheme, bucket, prefix = self._prefix()
        if scheme == "file":
            root = self.bucket_uri[len("file://"):]
            if not os.path.isdir(root):
                return []
            out = []
            for base, _dirs, files in os.walk(root):
                rel = os.path.relpath(base, root)
                for n in files:
                    if n.endswith(self.suffix):
                        out.append(n if rel == "." else os.path.join(rel, n))
            return sorted(out)
        if scheme == "gs":
            client = ObjectStorage._gcs()
            return sorted(b.name[len(prefix):]
                          for b in client.bucket(bucket).list_blobs(prefix=prefix)
                          if b.name.endswith(self.suffix))
        if scheme == "s3":
            s3 = ObjectStorage._s3()
            keys: List[str] = []
            token = None
            while True:  # paginate: list_objects_v2 caps at 1000 keys
                kw = {"Bucket": bucket, "Prefix": prefix}
                if token:
                    kw["ContinuationToken"] = token
                resp = s3.list_objects_v2(**kw)
                keys.extend(o["Key"][len(prefix):]
                            for o in resp.get("Contents", ())
                            if o["Key"].endswith(self.suffix))
                if not resp.get("IsTruncated"):
                    break
                token = resp.get("NextContinuationToken")
            return sorted(keys)
        raise ValueError(f"unsupported scheme {scheme!r}")

    def reset(self) -> None:
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._keys)

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        import tempfile

        import numpy as np

        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        if not self.has_next():
            raise StopIteration
        key = self._keys[self._pos]
        self._pos += 1
        with tempfile.TemporaryDirectory() as d:
            local = os.path.join(d, os.path.basename(key))
            self.storage.download(f"{self.bucket_uri}/{key}", local)
            with np.load(local, allow_pickle=False) as z:
                return DataSet(z["features"], z["labels"],
                               z["features_mask"] if "features_mask" in z else None,
                               z["labels_mask"] if "labels_mask" in z else None)

    @staticmethod
    def stage(datasets, bucket_uri: str,
              storage: Optional[ObjectStorage] = None,
              prefix: str = "part") -> List[str]:
        """Serialize DataSets into the bucket (the uploader half;
        ``S3Uploader`` role). Returns the written keys."""
        import tempfile

        import numpy as np
        storage = storage or ObjectStorage()
        keys = []
        for i, ds in enumerate(datasets):
            key = f"{prefix}-{i:05d}.npz"
            with tempfile.TemporaryDirectory() as d:
                local = os.path.join(d, key)
                arrs = {"features": np.asarray(ds.features),
                        "labels": np.asarray(ds.labels)}
                if ds.features_mask is not None:
                    arrs["features_mask"] = np.asarray(ds.features_mask)
                if ds.labels_mask is not None:
                    arrs["labels_mask"] = np.asarray(ds.labels_mask)
                np.savez(local, **arrs)
                storage.upload(local, f"{bucket_uri.rstrip('/')}/{key}")
            keys.append(key)
        return keys


class TpuJobRunner:
    """Ephemeral-cluster job execution: provision → stage → run → collect →
    teardown (the ``emr/SparkEMRClient.java`` role — its EMR cluster + spark
    submit become a TPU slice + per-worker script run). ``keep_alive`` keeps
    the slice after the job like the EMR client's keepClusterAfterExecution.
    """

    def __init__(self, cluster: ClusterProvisioner, keep_alive: bool = False):
        self.cluster = cluster
        self.keep_alive = keep_alive

    def run(self, job_script: str, setup_script: Optional[str] = None) -> List[str]:
        try:
            # inside the try: a PARTIAL create failure must still tear down
            # the workers that did come up (ephemeral semantics)
            self.cluster.create()
            self.cluster.block_till_all_running()
            if setup_script:
                self.cluster.provision_workers(setup_script)
            outs = self.cluster.provision_workers(job_script)
            return outs
        finally:
            if not self.keep_alive:
                self.cluster.teardown()
