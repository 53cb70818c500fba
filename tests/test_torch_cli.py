"""The port's command line against the JAX package's on the CPU.

Both packages' subcommands run in process on the same files (a zip the
reference wrote, CSVs and ``.npz`` data the test writes) with
``--device cpu`` on the port's side:

- ``evaluate`` prints the same ``Evaluation.stats()`` (default and explicit
  label column, ``--top-n``, ``--skip-lines``, ``--delimiter``);
- ``serve`` (non-blocking, port 0) answers one JSON and one binary
  request within 1e-5 of the reference network's ``output``; its flag
  errors carry the reference's messages, and ``--mesh`` raises as the
  port's registry does until the multi-device slice (ROADMAP §A 8);
- ``pipeline``: the rejected in-process flags and ``--eval-fraction``
  errors carry the reference's messages; a tiny MLP's run gives the
  reference's summaries, and the two served zips' weights lie within
  1e-5 × each tensor's largest entry;
- ``cloud-setup --dry-run`` prints the reference's command lines;
- ``profile`` prints the reference's report keys (ROADMAP §C: the port
  reads ``torch.profiler``, not HLO);
- ``train`` exits with status 2 naming ``parallel/trainer.py`` and §A 8;
- ``main``'s usage line and unknown-command message are the reference's
  (package name aside), and ``nn-server`` passes ``--device`` on.
"""

import copy
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import cli as r_cli
from deeplearning4j_tpu.nn.conf import InputType as RIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as RNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as RDense
from deeplearning4j_tpu.nn.layers import OutputLayer as ROut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as RMLN
from deeplearning4j_tpu.util import model_serializer as r_ser
from deeplearning4j_tpu_torch import cli as p_cli
from deeplearning4j_tpu_torch.serving import ModelServingClient
from deeplearning4j_tpu_torch.util import model_serializer as p_ser
from deeplearning4j_tpu_torch.util.convert import export_params
from test_torch_conv_family import jax_init, to_np
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
N_IN, N_OUT = 8, 3
W_TRUE = np.random.default_rng(7).normal(size=(N_IN, N_OUT)).astype(np.float32)


def same_text(port, ref):
    return port.replace("deeplearning4j_tpu_torch", "deeplearning4j_tpu") == ref


def classes(rng, n):
    x = rng.normal(size=(n, N_IN)).astype(np.float32)
    return x, (x @ W_TRUE).argmax(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    conf = (RNNC.builder().seed(1).list().layer(RDense(n_out=16, activation="relu"))
            .layer(ROut(n_out=N_OUT)).set_input_type(RIT.feed_forward(N_IN)).build())
    net = jax_init(RMLN, conf)
    rng = np.random.default_rng(3)
    x, y = classes(rng, 256)
    from deeplearning4j_tpu.datasets.dataset import DataSet
    net.fit(DataSet(x, np.eye(N_OUT, dtype=np.float32)[y]), epochs=2)
    model = str(root / "model.zip")
    r_ser.write_model(net, model)
    ex, ey = classes(rng, 50)
    rows = np.concatenate([ex, ey[:, None]], axis=1)
    np.savetxt(root / "eval.csv", rows, fmt="%.9g", delimiter=",")
    np.savetxt(root / "first.csv", np.concatenate([ey[:, None], ex], axis=1), fmt="%.9g",
               delimiter=";", header="label;features", comments="")
    px, py = classes(rng, 160)
    np.savez(root / "data.npz", features=px, labels=np.eye(N_OUT, dtype=np.float32)[py])
    config = json.load(open(os.path.join(REPO, "examples", "pipeline_config.json")))
    config["canary"]["schedule"] = [{"fraction": 0.25, "hold_s": 0.2},
                                    {"fraction": 0.5, "hold_s": 0.2}]
    json.dump(config, open(root / "pipeline.json", "w"))
    return dict(root=root, model=model, eval=str(root / "eval.csv"),
                first=str(root / "first.csv"), data=str(root / "data.npz"),
                config=str(root / "pipeline.json"), x=ex, net=net)


EVALS = {
    "last_column": ["--classes", "3"],
    "top_2_batch_7": ["--classes", "3", "--top-n", "2", "--batch", "7"],
    "first_column": ["--classes", "3", "--label-index", "0", "--delimiter", ";",
                     "--skip-lines", "1"],
}


@pytest.mark.parametrize("case", sorted(EVALS))
def test_evaluate_prints_the_reference_s_stats(case, files, capsys):
    csv = files["first"] if case == "first_column" else files["eval"]
    argv = ["--model", files["model"], "--csv", csv] + EVALS[case]
    port = p_cli.evaluate_main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    ref = r_cli.evaluate_main(argv)
    ref_out = capsys.readouterr().out
    assert port_out == ref_out == ref.stats() + "\n"
    assert port.stats() == ref.stats() and port.accuracy() == ref.accuracy()


def test_serve_answers_as_the_reference_network(files):
    server = p_cli.serve_main(["--model", f"clf={files['model']}", "--port", "0",
                               "--device", "cpu", "--max-batch-size", "4",
                               "--buckets", "1,4"], block=False)
    try:
        with urllib.request.urlopen(server.url + "/readyz", timeout=30) as r:
            assert r.status == 200
        client = ModelServingClient(server.url, timeout=60)
        x = files["x"][:3]
        want = np.asarray(files["net"].output(x))
        for binary in (False, True):
            got = client.predict("clf", x, binary=binary)
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    finally:
        server.stop(drain=True, shutdown_registry=True)


SERVE_ERRORS = {
    "buckets": ["--buckets", "a,b"],
    "buckets_zero": ["--buckets", "0"],
    "dtype_policy": ["--dtype-policy", "m=int4"],
    "dtype_policy_form": ["--dtype-policy", "int8"],
    "input_shape": ["--input-shape", "m=28xz"],
    "fallback": ["--fallback", "m=newest"],
    "unknown_name": ["--input-shape", "other=4"],
    "restarts": ["--max-dispatcher-restarts", "-1"],
    "rules_without_mesh": ["--sharding-rules", "rules.json"],
}


@pytest.mark.parametrize("case", sorted(SERVE_ERRORS))
def test_serve_flag_errors_carry_the_reference_s_messages(case, files, capsys):
    argv = ["--model", f"m={files['model']}", "--port", "0"] + SERVE_ERRORS[case]
    errs = []
    for main, extra in ((p_cli.serve_main, ["--device", "cpu"]), (r_cli.serve_main, [])):
        with pytest.raises(SystemExit) as e:
            main(argv + extra, block=False)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert same_text(*errs)


def test_serve_mesh_waits_for_the_multi_device_slice(files, capsys):
    """``serve --mesh`` serves since the sharded-serving slice: with no
    world it opens one of one rank (gloo for ``--device cpu``), where a
    mesh wanting two ranks is reported by ``p.error`` (exit 2) and
    ``data=1`` answers over HTTP as the reference's one-device mesh."""
    import torch.distributed as dist

    argv = ["--model", f"m={files['model']}", "--port", "0", "--device", "cpu"]
    try:
        with pytest.raises(SystemExit) as e:
            p_cli.serve_main(argv + ["--mesh", "data=2"], block=False)
        assert e.value.code == 2
        assert "--mesh: mesh wants 2 devices, only 1 available" in capsys.readouterr().err
        server = p_cli.serve_main(argv + ["--mesh", "data=1"], block=False)
        try:
            assert server.registry.get("m").describe()["versions"][0]["mesh"] == {"data": 1}
        finally:
            server.stop(drain=True, shutdown_registry=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


PIPELINE_ERRORS = {
    "in_process_flags": ["--trace", "out.json", "--watchdog", "raise", "--uiUrl", "u",
                         "--workers", "2"],
    "eval_fraction_high": ["--eval-fraction", "1.5"],
    "eval_fraction_zero": ["--eval-fraction", "0"],
}


@pytest.mark.parametrize("case", sorted(PIPELINE_ERRORS))
def test_pipeline_errors_carry_the_reference_s_messages(case, tmp_path, capsys):
    argv = ["--modelPath", "m.zip", "--dataPath", "d.npz", "--config", "c.json",
            "--state-dir", str(tmp_path)] + PIPELINE_ERRORS[case]
    errs = []
    for main in (p_cli.pipeline_main, r_cli.pipeline_main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])  # the usage wraps otherwise
    assert same_text(*errs)


def test_pipeline_run_summaries_equal_the_reference_s(files, tmp_path):
    argv = ["--modelPath", files["model"], "--dataPath", files["data"],
            "--config", files["config"], "--cycles", "2"]
    port = p_cli.pipeline_main(argv + ["--state-dir", str(tmp_path / "p"), "--device", "cpu",
                                       "--modelOutputPath", str(tmp_path / "p.zip")])
    ref = r_cli.pipeline_main(argv + ["--state-dir", str(tmp_path / "r"),
                                      "--modelOutputPath", str(tmp_path / "r.zip")])
    assert port == ref
    assert [s["outcome"] for s in port] == ["PROMOTE", "PROMOTE"]
    got = export_params(p_ser.restore_model(str(tmp_path / "p.zip"), device="cpu"))
    want = to_np(r_ser.restore_model(str(tmp_path / "r.zip")).params)
    for g, w in zip(got, want):
        for n in w:
            scale = float(np.abs(w[n]).max())
            assert np.abs(np.asarray(g[n]) - w[n]).max() <= TOL * scale, n


def test_cloud_setup_dry_run_prints_the_reference_s_commands(tmp_path, capsys):
    script = tmp_path / "w.sh"
    script.write_text("echo\n")
    argv = ["-w", "2", "--project", "p", "--zone", "z", "--accelerator-type", "v5e-4",
            "--name-prefix", "job", "--wscript", str(script), "--dry-run"]
    outs = []
    for main in (p_cli.cluster_setup_main, r_cli.cluster_setup_main):
        cluster = main(list(argv))
        outs.append((sorted(capsys.readouterr().out.splitlines()), cluster.names))
    assert outs[0] == outs[1] and len(outs[0][0]) == 8
    calls = []
    p_cli.cluster_setup_main(["--project", "p", "--zone", "z", "--device", "cpu"],
                             runner=lambda cmd: calls.append(cmd) or "READY")
    assert [c[4] for c in calls] == ["create", "describe"]


def test_profile_prints_the_reference_s_keys(files, tmp_path, capsys):
    out = tmp_path / "report.json"
    report = p_cli.profile_main(["--modelPath", files["model"], "--dataPath", files["data"],
                                 "--batchSize", "16", "--steps", "2", "--device", "cpu",
                                 "--out", str(out), "--logDir", str(tmp_path / "trace")])
    printed = json.loads(capsys.readouterr().out)
    assert printed == report == json.load(open(out))
    assert set(report) == {"device_ms_per_step", "buckets"} and report["device_ms_per_step"] > 0
    for bucket in report["buckets"].values():
        assert set(bucket) == {"share_pct", "ms_per_step", "tflops"}
        assert bucket["tflops"] is None
    assert abs(sum(b["share_pct"] for b in report["buckets"].values()) - 100) < 1
    assert "matrix products" in report["buckets"]
    assert os.path.exists(tmp_path / "trace" / "profile_trace.json")


@pytest.mark.parametrize("flags", [["--modelPath", "m.zip", "--dataPath", "d.npz",
                                    "--modelOutputPath", "o.zip"],
                                   ["--elastic", "2", "--ckpt-dir", "c"]])
def test_train_waits_for_the_multi_device_slice(flags, capsys):
    with pytest.raises(SystemExit) as e:
        p_cli.main(["train"] + flags)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "parallel/trainer.py" in err and "§A 8" in err


@pytest.mark.parametrize("argv,code", [([], 2), (["--help"], 0), (["-h"], 0),
                                       (["bogus"], 2)])
def test_main_usage_as_the_reference(argv, code, capsys):
    assert p_cli.main(list(argv)) == code
    port = capsys.readouterr().out
    assert r_cli.main(list(argv)) == code
    assert same_text(port, capsys.readouterr().out)


def test_nn_server_passes_the_device_on(monkeypatch):
    from deeplearning4j_tpu_torch.clustering import server as nn_server

    seen = {}

    class Stopped:
        port = 0

        class _thread:
            @staticmethod
            def join():
                raise KeyboardInterrupt

        def stop(self):
            seen["stopped"] = True

    def fake_main(argv, device=None):
        seen.update(argv=list(argv), device=device)
        return Stopped()

    monkeypatch.setattr(nn_server.NearestNeighborsServer, "main", staticmethod(fake_main))
    assert p_cli.main(["nn-server", "--ndarrayPath", "p.npy", "--device", "cpu",
                       "--port", "0"]) == 0
    assert seen == {"argv": ["--ndarrayPath", "p.npy", "--port", "0"], "device": "cpu",
                    "stopped": True}


def test_pipeline_flags_do_not_leak_the_sigterm_handler(files, tmp_path):
    import signal

    before = signal.getsignal(signal.SIGTERM)
    config = json.load(open(files["config"]))
    bad = copy.deepcopy(config)
    bad["canary"]["schedule"] = [{"fraction": 0.5, "hold_s": 0.0}]
    path = tmp_path / "c.json"
    json.dump(bad, open(path, "w"))
    p_cli.pipeline_main(["--modelPath", files["model"], "--dataPath", files["data"],
                         "--config", str(path), "--state-dir", str(tmp_path / "s"),
                         "--device", "cpu"])
    assert signal.getsignal(signal.SIGTERM) == before
    assert threading.current_thread() is threading.main_thread()
