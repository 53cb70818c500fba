"""The port's preemption handler, scikit-learn adapters and cloud helpers
against the JAX package's on the CPU.

- Preemption: a SIGTERM sent to the test process from a listener during
  ``fit`` saves the zip (``preemption_state.json`` inside) at that step
  boundary; a SIGTERM that lands between two tensors' updates of one step
  is saved only when the step ends, so the zip holds the whole step and
  not the half-updated network the signal saw; each package resumes the
  other's zip (parameters equal, iteration and epoch restored);
  ``backend="orbax"`` raises naming ``util/orbax_checkpoint.py`` and
  ROADMAP §A 8; the refusals carry the reference's messages.
- The adapters: ``SklearnDl4jClassifier`` and ``SklearnDl4jRegressor`` fit
  from the reference's initial weights (carried into the port's network)
  and give ``predict_proba`` / ``predict`` within 1e-5, the same labels
  and scores within 1e-5; ``get_params`` is the reference's plus
  ``device``; sklearn's ``clone`` and ``Pipeline`` take them.
- Cloud: every command builder's list, the commands a fake runner sees
  from the cluster and job runner, ``file://`` storage and
  ``BucketDataSetIterator`` over a ``file://`` bucket (each package
  reading what the other staged) equal the reference's; gs:// and s3://
  without their libraries raise the same ``ImportError``.
"""

import os
import signal
import sys
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import cloud as r_cloud
from deeplearning4j_tpu import sklearn_adapter as r_sk
from deeplearning4j_tpu.datasets.dataset import DataSet as RDataSet
from deeplearning4j_tpu.nn.conf import InputType as RIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as RNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as RDense
from deeplearning4j_tpu.nn.layers import OutputLayer as ROut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as RMLN
from deeplearning4j_tpu.util import preemption as r_pre
from deeplearning4j_tpu_torch import cloud as p_cloud
from deeplearning4j_tpu_torch import sklearn_adapter as p_sk
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as PDataSet
from deeplearning4j_tpu_torch.nn import helpers
from deeplearning4j_tpu_torch.nn.conf import InputType as PIT
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as PNNC
from deeplearning4j_tpu_torch.nn.layers import DenseLayer as PDense
from deeplearning4j_tpu_torch.nn.layers import OutputLayer as POut
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as PMLN
from deeplearning4j_tpu_torch.util import preemption as p_pre
from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params
from test_torch_conv_family import jax_init, to_np
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
N_IN = 6


def mlp_conf(NNC, Dense, Out, IT, n_in=N_IN, n_out=3, regression=False, seed=0):
    out = (Out(n_out=n_out, activation="identity", loss="mse") if regression
           else Out(n_out=n_out))
    return (NNC.builder().seed(seed).list()
            .layer(Dense(n_out=16, activation="tanh" if regression else "relu"))
            .layer(out).set_input_type(IT.feed_forward(n_in)).build())


def port_conf(n_in, n_out, regression=False):
    return mlp_conf(PNNC, PDense, POut, PIT, n_in, n_out, regression)


def ref_conf(n_in, n_out, regression=False):
    return mlp_conf(RNNC, RDense, ROut, RIT, n_in, n_out, regression)


def data(n=96, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)
    x = rng.normal(size=(n, N_IN)).astype(np.float32)
    x[np.arange(n), y] += 2.0
    return x, y


def params_of(net):
    got = export_params(net)
    return [{n: np.asarray(a) for n, a in named.items()} for named in got]


def assert_params_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for n in x:
            assert np.array_equal(np.asarray(x[n]), np.asarray(y[n])), n


# ------------------------------------------------------------------ preemption
class Snapshots:
    """A listener keeping each step boundary's parameters; optionally a
    SIGTERM to this process at one iteration."""

    def __init__(self, signal_at=None):
        self.signal_at, self.at = signal_at, {}

    def iteration_done(self, model, iteration, epoch):
        self.at[iteration] = (epoch, params_of(model))
        if iteration == self.signal_at:
            os.kill(os.getpid(), signal.SIGTERM)


def batches(n=5, seed=1):
    x, y = data(16 * n, seed)
    onehot = np.eye(3, dtype=np.float32)[y]
    return [PDataSet(x[i:i + 16], onehot[i:i + 16]) for i in range(0, 16 * n, 16)]


def test_sigterm_mid_fit_saves_the_step_boundary(tmp_path):
    net = PMLN(port_conf(N_IN, 3), device="cpu").init()
    snaps = Snapshots(signal_at=3)
    net.listeners.append(snaps)
    path = str(tmp_path / "ckpt" / "preempt.zip")
    handler = p_pre.PreemptionHandler(net, path, exit_after_save=False)
    previous = signal.getsignal(signal.SIGTERM)
    with handler:
        assert signal.getsignal(signal.SIGTERM) == handler._handle
        net.fit(batches(), epochs=1)
    assert signal.getsignal(signal.SIGTERM) == previous
    assert handler.preempted.is_set() and handler.saved.is_set()
    assert net.iteration == 5 and not net.step_end_hooks
    model, state = p_pre.PreemptionHandler.resume(path, device="cpu")
    assert state == {"iteration": 3, "epoch": 0}
    assert (model.iteration, model.epoch) == (3, 0)
    assert_params_equal(params_of(model), snaps.at[3][1])
    back, rstate = handler.rollback(device="cpu")
    assert rstate == state


class SignalBetweenTensors:
    """An "updater" helper with the stock update that sends SIGTERM right
    after writing the first tensor of step ``at``."""

    def __init__(self, at):
        self.at, self.sent = at, False

    def supports(self, u, p, g):
        return True

    def apply(self, u, p, g, state, lr, t):
        upd, state = u.update(g, state, lr, t)
        p.sub_(upd.to(p.dtype))
        if int(t) == self.at and not self.sent:
            self.sent = True
            os.kill(os.getpid(), signal.SIGTERM)
        return p, state


def test_sigterm_inside_a_step_is_saved_at_the_step_end(tmp_path):
    net = PMLN(port_conf(N_IN, 3), device="cpu").init()
    snaps = Snapshots()
    net.listeners.append(snaps)
    seen = {}
    path = str(tmp_path / "preempt.zip")
    handler = p_pre.PreemptionHandler(
        net, path, on_preempt=lambda h: seen.update(
            params=params_of(h.model), in_step=h.model.in_step,
            saved=h.saved.is_set()))
    helpers.set_helper("updater", SignalBetweenTensors(at=2))
    try:
        with handler:
            net.fit(batches(4), epochs=1)
    finally:
        helpers.clear_helper("updater")
    # the signal saw a half-updated step: the first tensor written, the rest not
    assert seen["in_step"] and not seen["saved"]
    half, before, after = seen["params"], snaps.at[1][1], snaps.at[2][1]
    assert not np.array_equal(half[0]["W"], before[0]["W"])
    assert np.array_equal(half[0]["b"], before[0]["b"])
    assert np.array_equal(half[1]["W"], before[1]["W"])
    model, state = p_pre.PreemptionHandler.resume(path, device="cpu")
    assert state == {"iteration": 2, "epoch": 0}
    assert_params_equal(params_of(model), after)


def test_each_package_resumes_the_other_s_zip(tmp_path):
    port = PMLN(port_conf(N_IN, 3), device="cpu").init()
    port.fit(batches(3), epochs=2)
    p_path = str(tmp_path / "port.zip")
    p_pre.PreemptionHandler(port, p_path).save()
    ref_model, ref_state = r_pre.PreemptionHandler.resume(p_path)
    assert ref_state == {"iteration": 6, "epoch": 2}
    assert (ref_model.iteration, ref_model.epoch) == (6, 2)
    assert_params_equal([{n: np.asarray(a) for n, a in d.items()}
                         for d in to_np(ref_model.params)], params_of(port))

    ref = jax_init(RMLN, ref_conf(N_IN, 3))
    x, y = data(32, 4)
    ref.fit(RDataSet(x, np.eye(3, dtype=np.float32)[y]), epochs=3)
    r_path = str(tmp_path / "ref.zip")
    r_pre.PreemptionHandler(ref, r_path).save()
    model, state = p_pre.PreemptionHandler.resume(r_path, device="cpu")
    assert state == {"iteration": 3, "epoch": 3} and (model.iteration, model.epoch) == (3, 3)
    assert_params_equal(params_of(model), [{n: np.asarray(a) for n, a in d.items()}
                                           for d in to_np(ref.params)])
    np.testing.assert_allclose(model.output(x).numpy(), np.asarray(ref.output(x)),
                               rtol=0, atol=TOL)


def test_orbax_backend_waits_for_the_multi_device_slice(tmp_path):
    net = PMLN(port_conf(N_IN, 3), device="cpu").init()
    with pytest.raises(NotImplementedError) as e:
        p_pre.PreemptionHandler(net, str(tmp_path / "ckpt"), backend="orbax")
    assert "util/orbax_checkpoint.py" in str(e.value) and "§A 8" in str(e.value)
    os.makedirs(tmp_path / "dir")
    with pytest.raises(NotImplementedError, match="orbax_checkpoint"):
        p_pre.PreemptionHandler.resume(str(tmp_path / "dir"))


def test_refusals_carry_the_reference_s_messages(tmp_path):
    net = PMLN(port_conf(N_IN, 3), device="cpu").init()
    ref = jax_init(RMLN, ref_conf(N_IN, 3))
    got = []
    for mod, model in ((p_pre, net), (r_pre, ref)):
        with pytest.raises(ValueError) as bad:
            mod.PreemptionHandler(model, "x.zip", backend="tar")
        with pytest.raises(RuntimeError) as early:
            mod.PreemptionHandler(model, str(tmp_path / "none.zip")).rollback()
        box = {}

        def off_main():
            try:
                mod.PreemptionHandler(model, "x.zip").arm()
            except RuntimeError as e:
                box["e"] = str(e)

        t = threading.Thread(target=off_main)
        t.start()
        t.join()
        got.append((str(bad.value), str(early.value), box["e"].split(". From")[0]))
    assert got[0] == got[1]


def test_exit_after_save_raises_system_exit_143(tmp_path):
    net = PMLN(port_conf(N_IN, 3), device="cpu").init()
    net.fit(batches(1))
    path = str(tmp_path / "exit.zip")
    handler = p_pre.PreemptionHandler(net, path, exit_after_save=True).arm()
    try:
        with pytest.raises(SystemExit) as e:
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(1000):  # the handler runs at the next bytecode
                pass
        assert e.value.code == 143 and os.path.exists(path)
    finally:
        handler.disarm()


# ------------------------------------------------------------------ adapters
@pytest.fixture
def carried(monkeypatch):
    """The reference's initial weights, recorded at each reference init
    and loaded into the next port init (in order)."""
    inits = []
    r_init, p_init = RMLN.init, PMLN.init

    def record(self, *a, **k):
        out = r_init(self, *a, **k)
        inits.append(to_np(self.params))
        return out

    def load(self, *a, **k):
        out = p_init(self, *a, **k)
        load_reference_params(self, inits.pop(0))
        return out

    monkeypatch.setattr(RMLN, "init", record)
    monkeypatch.setattr(PMLN, "init", load)
    return inits


@pytest.mark.parametrize("labels", ["ints", "strings", "one_hot"])
def test_classifier_as_the_reference(carried, labels):
    x, y = data()
    if labels == "strings":
        y = np.array(["a", "b", "c"])[y]
    elif labels == "one_hot":
        y = np.eye(3, dtype=np.float32)[y]
    ref = r_sk.SklearnDl4jClassifier(ref_conf, epochs=3, batch_size=32, seed=3).fit(x, y)
    port = p_sk.SklearnDl4jClassifier(port_conf, epochs=3, batch_size=32, seed=3,
                                      device="cpu").fit(x, y)
    np.testing.assert_allclose(port.predict_proba(x), np.asarray(ref.predict_proba(x)),
                               rtol=0, atol=TOL)
    assert np.array_equal(port.predict(x), ref.predict(x))
    assert np.array_equal(port.classes_, ref.classes_)
    truth = y if labels != "one_hot" else y.argmax(1)
    if labels != "one_hot":
        assert abs(port.score(x, truth) - ref.score(x, truth)) <= TOL


@pytest.mark.parametrize("columns", [1, 2])
def test_regressor_as_the_reference(carried, columns):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = (x @ rng.normal(size=(4, columns))).astype(np.float32)
    y = y[:, 0] if columns == 1 else y

    def factory(conf):
        return lambda n_in, n_out: conf(n_in, n_out, regression=True)

    ref = r_sk.SklearnDl4jRegressor(factory(ref_conf), epochs=5, batch_size=16).fit(x, y)
    port = p_sk.SklearnDl4jRegressor(factory(port_conf), epochs=5, batch_size=16,
                                     device="cpu").fit(x, y)
    np.testing.assert_allclose(port.predict(x), np.asarray(ref.predict(x)), rtol=0, atol=TOL)
    assert port.predict(x).shape == ref.predict(x).shape
    assert abs(port.score(x, y) - ref.score(x, y)) <= TOL


def test_adapter_params_clone_and_pipeline():
    from sklearn.base import clone
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler

    port = p_sk.SklearnDl4jClassifier(port_conf, epochs=2, device="cpu")
    ref = r_sk.SklearnDl4jClassifier(ref_conf, epochs=2)
    want = dict(ref.get_params(), conf_factory=port_conf, device="cpu")
    assert port.get_params() == want
    port.set_params(epochs=4, batch_size=8)
    assert (port.epochs, port.batch_size) == (4, 8)
    with pytest.raises(ValueError, match="unknown parameter 'nonsense'"):
        port.set_params(nonsense=1)
    twin = clone(port)
    assert twin.get_params() == port.get_params() and twin.network_ is None
    with pytest.raises(RuntimeError, match="fit must be called before predict"):
        twin.predict_proba(np.zeros((1, N_IN), np.float32))
    x, y = data(64, 5)
    pipe = Pipeline([("scale", StandardScaler()), ("net", twin)]).fit(x, y)
    assert pipe.predict(x).shape == (64,) and pipe.named_steps["net"].network_.device.type == "cpu"


# ------------------------------------------------------------------ cloud
def collecting(out, answer="READY"):
    def run(cmd):
        out.append(list(cmd))
        return answer
    return run


def test_command_builders_equal_the_reference(tmp_path):
    script = tmp_path / "setup script;rm.sh"
    script.write_text("#!/bin/sh\n")
    got = []
    for C in (p_cloud, r_cloud):
        cmds = []
        prov = C.TpuProvisioner("proj", "us-central2-b", runner=collecting(cmds))
        lists = [prov.create_command("vm", accelerator_type="v5litepod-8"),
                 prov.delete_command("vm"), prov.ssh_command("vm", "echo hi", worker="0")]
        prov.create("a")
        prov.delete("a")
        prov.run_on("a", "uname")
        host = C.HostProvisioner(prov, "vm", worker="1")
        lists.append(host.scp_command("local.sh", "/tmp/x.sh"))
        host.upload_and_run(str(script))
        host.upload_and_run(str(script), root_dir="~")
        host.upload_and_run(str(script), root_dir="~/bin")
        host.run_remote_command("ls")
        cluster = C.ClusterProvisioner(prov, num_workers=3, name_prefix="w")
        lists.append(cluster.describe_command("w-0"))
        got.append((lists, cmds, cluster.names))
    assert got[0] == got[1]


def test_cluster_and_job_runner_commands_as_the_reference(tmp_path):
    script = tmp_path / "job.sh"
    script.write_text("#!/bin/sh\n")
    got = []
    for C in (p_cloud, r_cloud):
        cmds = []
        prov = C.TpuProvisioner("p", "z", runner=collecting(cmds))
        cluster = C.ClusterProvisioner(prov, num_workers=3)
        outs = C.TpuJobRunner(cluster).run(str(script), setup_script=str(script))
        kept = []
        C.TpuJobRunner(C.ClusterProvisioner(C.TpuProvisioner("p", "z", runner=collecting(
            kept)), num_workers=1), keep_alive=True).run(str(script))
        slow = C.ClusterProvisioner(C.TpuProvisioner("p", "z", runner=collecting(
            [], "CREATING")), num_workers=1)
        with pytest.raises(TimeoutError) as e:
            slow.block_till_all_running(poll_seconds=0.0, timeout=0.0)
        got.append((sorted(map(tuple, cmds)), outs, sorted(map(tuple, kept)), str(e.value),
                    C.ClusterProvisioner(prov, num_workers=0).create()))
    assert got[0] == got[1]


def test_file_storage_and_bucket_iterator_cross_the_packages(tmp_path):
    rng = np.random.default_rng(6)
    sets = [(rng.normal(size=(4, 3)).astype(np.float32),
             rng.normal(size=(4, 2)).astype(np.float32),
             None if i % 2 else (rng.random(4) > 0.5).astype(np.float32), None)
            for i in range(3)]
    bucket = f"file://{tmp_path}/bucket/data"
    p_keys = p_cloud.BucketDataSetIterator.stage([PDataSet(*s) for s in sets], bucket)
    r_keys = r_cloud.BucketDataSetIterator.stage([RDataSet(*s) for s in sets],
                                                 f"file://{tmp_path}/bucket/ref", prefix="r")
    os.makedirs(tmp_path / "bucket" / "data" / "nested")
    np.savez(tmp_path / "bucket" / "data" / "nested" / "deep.npz",
             features=sets[0][0], labels=sets[0][1])
    (tmp_path / "bucket" / "data-old").mkdir()
    np.savez(tmp_path / "bucket" / "data-old" / "stale.npz", features=sets[0][0],
             labels=sets[0][1])
    for uri in (bucket, f"file://{tmp_path}/bucket/ref"):
        p_it, r_it = p_cloud.BucketDataSetIterator(uri), r_cloud.BucketDataSetIterator(uri)
        assert p_it.list_keys() == r_it.list_keys()
        for a, b in zip(list(p_it), list(r_it)):
            assert isinstance(a, PDataSet)
            for u, v in ((a.features, b.features), (a.labels, b.labels),
                         (a.features_mask, b.features_mask), (a.labels_mask, b.labels_mask)):
                assert (u is None and v is None) or np.array_equal(u, np.asarray(v))
    assert p_keys == [f"part-{i:05d}.npz" for i in range(3)] and len(r_keys) == 3
    assert p_cloud.BucketDataSetIterator(f"file://{tmp_path}/missing").list_keys() == []
    src = tmp_path / "blob.bin"
    src.write_bytes(b"abc")
    for C in (p_cloud, r_cloud):
        store = C.ObjectStorage()
        store.upload(str(src), f"file://{tmp_path}/up/{C.__name__}/blob.bin")
        store.download(f"file://{tmp_path}/up/{C.__name__}/blob.bin", str(tmp_path / "got"))
        assert (tmp_path / "got").read_bytes() == b"abc"
    assert p_cloud.ObjectStorage._parse("gs://b/k/x") == r_cloud.ObjectStorage._parse("gs://b/k/x")


def test_gs_and_s3_without_their_libraries_as_the_reference(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "google.cloud", None)
    monkeypatch.setitem(sys.modules, "boto3", None)
    got = []
    for C in (p_cloud, r_cloud):
        row = []
        for call in (lambda: C.ObjectStorage._gcs(), lambda: C.ObjectStorage._s3(),
                     lambda: C.ObjectStorage().upload(str(tmp_path), "ftp://h/x"),
                     lambda: C.BucketDataSetIterator("hdfs://h/x")):
            with pytest.raises((ImportError, ValueError)) as e:
                call()
            row.append((type(e.value).__name__, str(e.value)))
        got.append(row)
    assert got[0] == got[1]


def test_fit_from_a_bucket_on_the_port(tmp_path):
    x, y = data(48, 7)
    onehot = np.eye(3, dtype=np.float32)[y]
    bucket = f"file://{tmp_path}/train"
    r_cloud.BucketDataSetIterator.stage([RDataSet(x[i:i + 16], onehot[i:i + 16])
                                         for i in range(0, 48, 16)], bucket)
    net = PMLN(port_conf(N_IN, 3), device="cpu").init()
    twin = net.clone()
    net.fit(p_cloud.BucketDataSetIterator(bucket), epochs=2)
    for _ in range(2):
        for i in range(0, 48, 16):
            twin.fit(PDataSet(x[i:i + 16], onehot[i:i + 16]))
    assert_params_equal(params_of(net), params_of(twin))
    assert torch.equal(net.output(x), twin.output(x))
