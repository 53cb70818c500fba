"""The port stands alone: no jax, jaxlib or deeplearning4j_tpu import in
its modules or in chip_smoke.py, and its entry points refuse to guess a
device."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "deeplearning4j_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(module: str) -> bool:
    # the module itself or a submodule: deeplearning4j_tpu_torch is fine
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_matcher():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("deeplearning4j_tpu") and _forbidden("deeplearning4j_tpu.nn")
    assert not _forbidden("deeplearning4j_tpu_torch.nn")
    assert not _forbidden("jaxtyping")


def test_no_forbidden_imports():
    files = _port_files()
    assert len(files) > 15
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {m}"
                    for m in mods if _forbidden(m)]
    assert not bad, bad


def test_import_leaves_jax_unloaded():
    code = ("import sys, deeplearning4j_tpu_torch, "
            "deeplearning4j_tpu_torch.nn.graph, "
            "deeplearning4j_tpu_torch.nn.multilayer, "
            "deeplearning4j_tpu_torch.nn.layers.recurrent, "
            "deeplearning4j_tpu_torch.nn.conf.network, "
            "deeplearning4j_tpu_torch.zoo.models, "
            "deeplearning4j_tpu_torch.parallel.inference, "
            "deeplearning4j_tpu_torch.util.convert, "
            "deeplearning4j_tpu_torch.util.model_serializer, "
            "deeplearning4j_tpu_torch.eval.evaluation, "
            "deeplearning4j_tpu_torch.nn.conf.preprocessors, "
            "deeplearning4j_tpu_torch.nn.layers.conv, "
            "deeplearning4j_tpu_torch.nn.layers.pooling, "
            "deeplearning4j_tpu_torch.nn.layers.vae, "
            "deeplearning4j_tpu_torch.nn.layers.autoencoder, "
            "deeplearning4j_tpu_torch.nn.layers.objdetect, "
            "deeplearning4j_tpu_torch.nn.layers.wrappers, "
            "deeplearning4j_tpu_torch.nn.layers.moe, "
            "deeplearning4j_tpu_torch.nn.simple, "
            "deeplearning4j_tpu_torch.autodiff.samediff, "
            "deeplearning4j_tpu_torch.nn.layers.samediff, "
            "deeplearning4j_tpu_torch.nn.transferlearning, "
            "deeplearning4j_tpu_torch.nn.conf.memory, "
            "deeplearning4j_tpu_torch.zoo.zoo_model, "
            "deeplearning4j_tpu_torch.zoo.labels, "
            "deeplearning4j_tpu_torch.optimize, "
            "deeplearning4j_tpu_torch.optimize.listeners, "
            "deeplearning4j_tpu_torch.optimize.solvers, "
            "deeplearning4j_tpu_torch.optimize.earlystopping, "
            "deeplearning4j_tpu_torch.optimize.hpo, "
            "deeplearning4j_tpu_torch.util.gradient_check, "
            "deeplearning4j_tpu_torch.ui, "
            "deeplearning4j_tpu_torch.ui.storage, "
            "deeplearning4j_tpu_torch.ui.components, "
            "deeplearning4j_tpu_torch.ui.stats, "
            "deeplearning4j_tpu_torch.ui.modules, "
            "deeplearning4j_tpu_torch.ui.remote, "
            "deeplearning4j_tpu_torch.ui.server, "
            "deeplearning4j_tpu_torch.observe, "
            "deeplearning4j_tpu_torch.observe.metrics, "
            "deeplearning4j_tpu_torch.observe.listener, "
            "deeplearning4j_tpu_torch.observe.health, "
            "deeplearning4j_tpu_torch.observe.alerts, "
            "deeplearning4j_tpu_torch.observe.slo, "
            "deeplearning4j_tpu_torch.observe.fleet, "
            "deeplearning4j_tpu_torch.observe.incident, "
            "deeplearning4j_tpu_torch.observe.export, "
            "deeplearning4j_tpu_torch.serving, "
            "deeplearning4j_tpu_torch.serving.admission, "
            "deeplearning4j_tpu_torch.serving.brownout, "
            "deeplearning4j_tpu_torch.serving.server, "
            "deeplearning4j_tpu_torch.serving.client, "
            "deeplearning4j_tpu_torch.serving.metrics, "
            "deeplearning4j_tpu_torch.streaming, "
            "deeplearning4j_tpu_torch.streaming.codec, "
            "deeplearning4j_tpu_torch.util.fsio, "
            "deeplearning4j_tpu_torch.streaming.broker, "
            "deeplearning4j_tpu_torch.streaming.kafka, "
            "deeplearning4j_tpu_torch.streaming.route, "
            "deeplearning4j_tpu_torch.pipeline, "
            "deeplearning4j_tpu_torch.datasets.records, "
            "deeplearning4j_tpu_torch.datasets.fetchers, "
            "deeplearning4j_tpu_torch.util.preemption, "
            "deeplearning4j_tpu_torch.sklearn_adapter, "
            "deeplearning4j_tpu_torch.cloud, "
            "deeplearning4j_tpu_torch.cli, "
            "deeplearning4j_tpu_torch.eval.tools; "
            "deeplearning4j_tpu_torch.SameDiff; "
            "deeplearning4j_tpu_torch.EarlyStoppingTrainer; "
            "deeplearning4j_tpu_torch.Solver; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_need_an_explicit_cpu(tmp_path):
    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import LSTMLayer, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_multi_layer_network,
    )
    from deeplearning4j_tpu_torch.zoo.models import LeNet, TransformerLM

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    conf = TransformerLM(vocab_size=10, max_length=8, n_layers=1, d_model=16,
                         n_heads=2, d_ff=32).conf()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ComputationGraph(conf).init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(vocab_size=10, max_length=8, n_layers=1, d_model=16,
                      n_heads=2, d_ff=32).init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    net = ComputationGraph(conf, device="cpu").init()
    assert all(p.device.type == "cpu" for p in net.parameters())
    out = net.output(np.zeros((1, 8), np.float32))
    assert out.shape == (1, 8, 10)

    lstm_conf = (NeuralNetConfiguration.builder().list()
                 .layer(LSTMLayer(n_out=4)).layer(RnnOutputLayer(n_out=3))
                 .set_input_type(InputType.recurrent(3)).build())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiLayerNetwork(lstm_conf)
    mln = MultiLayerNetwork(lstm_conf, device="cpu").init()
    assert all(p.device.type == "cpu" for p in mln.parameters())
    assert mln.output(np.zeros((1, 5, 3), np.float32)).shape == (1, 5, 3)

    # the model zip: restoring picks cuda unless the caller asks for the CPU
    path = os.path.join(str(tmp_path), "m.zip")
    mln.save(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiLayerNetwork.load(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_multi_layer_network(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LeNet().init()
    back = MultiLayerNetwork.load(path, device="cpu")
    assert all(p.device.type == "cpu" for p in back.parameters())
    assert restore_multi_layer_network(path, device="cpu").iteration == 0

    # the NLP stack: the embedding models, the lookup table and the
    # serializer's readers pick cuda unless the caller asks for the CPU
    from deeplearning4j_tpu_torch.nlp import (
        Glove,
        InMemoryLookupTable,
        ParagraphVectors,
        SequenceVectors,
        Word2Vec,
        WordVectorSerializer,
    )

    for model in (SequenceVectors, Word2Vec, ParagraphVectors, Glove):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model(layer_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Word2Vec.builder().layer_size(4).build()
    w2v = Word2Vec(layer_size=4, min_word_frequency=1, device="cpu").fit(["a b c", "b c d"])
    assert w2v.lookup_table.syn0.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InMemoryLookupTable(w2v.vocab, 4)
    files = {"txt": ("write_word_vectors", "load_txt_vectors"),
             "bin": ("write_binary_model", "read_binary_model"),
             "zip": ("write_word2vec_model", "read_word2vec_model")}
    for ext, (write, read) in files.items():
        vec_path = os.path.join(str(tmp_path), f"v.{ext}")
        getattr(WordVectorSerializer, write)(w2v, vec_path)
        for reader in (getattr(WordVectorSerializer, read), WordVectorSerializer.load_static_model):
            with pytest.raises(Exception, match="no CUDA device"):
                reader(vec_path)
        back_vec = getattr(WordVectorSerializer, read)(vec_path, device="cpu")
        assert back_vec.lookup_table.syn0.device.type == "cpu"

    # graph embeddings, nearest neighbours, k-means, LSH, t-SNE and the
    # k-NN server pick cuda unless the caller asks for the CPU
    from deeplearning4j_tpu_torch.clustering import (
        BruteForceNearestNeighbors,
        KMeansClustering,
        RandomProjectionLSH,
        knn,
    )
    from deeplearning4j_tpu_torch.clustering.server import NearestNeighborsServer
    from deeplearning4j_tpu_torch.graph import (
        DeepWalk,
        Graph,
        GraphVectorSerializer,
        InMemoryGraphLookupTable,
        Node2Vec,
    )
    from deeplearning4j_tpu_torch.plot import BarnesHutTsne, Tsne

    pts = np.arange(12, dtype=np.float32).reshape(6, 2)
    refusals = [lambda: DeepWalk(vector_size=4), lambda: Node2Vec(vector_size=4),
                lambda: DeepWalk.Builder().vector_size(4).build(),
                lambda: InMemoryGraphLookupTable(3, 4, None, 0.01),
                lambda: BruteForceNearestNeighbors(pts), lambda: KMeansClustering(2),
                lambda: KMeansClustering.setup(2), lambda: RandomProjectionLSH(4, 2),
                lambda: Tsne(), lambda: BarnesHutTsne(), lambda: NearestNeighborsServer(pts)]
    for refused in refusals:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            refused()
    g = Graph(3)
    g.add_edge(0, 1)
    g.add_edge(1, 2)
    dw = DeepWalk(vector_size=4, window_size=1, device="cpu")
    dw.fit(g, walk_length=4)
    assert dw.lookup_table.vertex_vectors.device.type == "cpu"
    vec_path = os.path.join(str(tmp_path), "graph_vectors.txt")
    GraphVectorSerializer.write_graph_vectors(dw, vec_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphVectorSerializer.load_txt_vectors(vec_path)
    back = GraphVectorSerializer.load_txt_vectors(vec_path, device="cpu")
    assert back.lookup_table.vertex_vectors.device.type == "cpu"
    assert BruteForceNearestNeighbors(pts, device="cpu").points.device.type == "cpu"
    assert NearestNeighborsServer(pts, use_device=False)._index is None
    # the functions follow their tensors
    assert knn(torch.from_numpy(pts), torch.from_numpy(pts), 2)[1].device.type == "cpu"


def test_samediff_and_the_zoo_base_need_an_explicit_cpu(tmp_path, monkeypatch):
    """SameDiff, its npz and ``init_pretrained`` pick cuda unless the
    caller asks for the CPU."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.zoo import LeNet

    with pytest.raises(RuntimeError, match="no CUDA device"):
        SameDiff.create()
    sd = SameDiff.create(device="cpu")
    sd.var("w", value=np.ones(3, np.float32))
    sd.save(os.path.join(str(tmp_path), "g"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SameDiff.load(os.path.join(str(tmp_path), "g.npz"))
    assert SameDiff.load(os.path.join(str(tmp_path), "g.npz"),
                         device="cpu").variables_map["w"].device.type == "cpu"
    monkeypatch.setenv("DL4J_TPU_ZOO_DIR", str(tmp_path))
    LeNet(input_shape=(1, 12, 12)).init(device="cpu").save(
        os.path.join(str(tmp_path), "lenet_mnist.zip"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LeNet(input_shape=(1, 12, 12)).init_pretrained("mnist")
    net = LeNet(input_shape=(1, 12, 12)).init_pretrained("mnist", device="cpu")
    assert all(p.device.type == "cpu" for p in net.parameters())


def test_solver_and_early_stopping_follow_the_model_s_device(tmp_path):
    """``Solver``, ``EarlyStoppingTrainer``, its calculators and savers, and
    the checkpoint loader run where the model lies; what builds or
    restores a network with no model to follow picks cuda unless the
    caller asks for the CPU."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize import (
        CheckpointListener,
        DataSetLossCalculator,
        EarlyStoppingConfiguration,
        EarlyStoppingTrainer,
        LocalFileModelSaver,
        MaxEpochsTerminationCondition,
        Solver,
    )
    from deeplearning4j_tpu_torch.util.gradient_check import check_model_gradients

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    conf = (NeuralNetConfiguration.builder().seed(1).optimization_algo("lbfgs").list()
            .layer(DenseLayer(n_out=4, activation="tanh")).layer(OutputLayer(n_out=2))
            .set_input_type(InputType.feed_forward(3)).build())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Solver(MultiLayerNetwork(conf))
    rng = np.random.default_rng(0)
    ds = DataSet(rng.normal(size=(8, 3)).astype(np.float32),
                 np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)])
    net = MultiLayerNetwork(conf, device="cpu").init()
    Solver(net, max_iterations=2).optimize(ds)
    assert all(p.device.type == "cpu" for p in net.parameters())
    assert check_model_gradients(net, ds.features, ds.labels, subset=2)
    net.set_listeners(CheckpointListener(tmp_path / "cp", save_every_n_epochs=1))
    cfg = EarlyStoppingConfiguration(
        score_calculator=DataSetLossCalculator(ListDataSetIterator(ds, 4)),
        epoch_termination_conditions=[MaxEpochsTerminationCondition(2)],
        model_saver=LocalFileModelSaver(tmp_path / "es"))
    result = EarlyStoppingTrainer(cfg, net, ListDataSetIterator(ds, 4)).fit()
    assert all(p.device.type == "cpu" for p in result.best_model.parameters())
    # a saver or loader with no model to follow
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalFileModelSaver(tmp_path / "es").get_best_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckpointListener.load_checkpoint(tmp_path / "cp")
    assert CheckpointListener.load_checkpoint(tmp_path / "cp", device="cpu").epoch == 2


def test_chip_smoke_refuses_without_a_card():
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_training_modules_leave_jax_unloaded():
    """The training slice's modules (updaters, losses, datasets, the
    kernels' module, the optimizer-state converters) import no jax."""
    code = ("import sys, deeplearning4j_tpu_torch.nn.updaters, "
            "deeplearning4j_tpu_torch.nn.losses, "
            "deeplearning4j_tpu_torch.datasets.dataset, "
            "deeplearning4j_tpu_torch.nn.cuda_kernels, "
            "deeplearning4j_tpu_torch.nn.layers.output, "
            "deeplearning4j_tpu_torch.util.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_regularizer_and_pipeline_modules_leave_jax_unloaded():
    """The regularizers and the input pipeline (dropout, weight noise,
    constraints, the tick, iterators, normalizers) import no jax."""
    code = ("import sys, deeplearning4j_tpu_torch.nn.dropout, "
            "deeplearning4j_tpu_torch.nn.weightnoise, "
            "deeplearning4j_tpu_torch.nn.constraints, "
            "deeplearning4j_tpu_torch.nn.tick, "
            "deeplearning4j_tpu_torch.datasets.iterators, "
            "deeplearning4j_tpu_torch.datasets.normalizers, "
            "deeplearning4j_tpu_torch.datasets; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    names = {os.path.relpath(p, REPO) for p in _port_files()}
    assert {"deeplearning4j_tpu_torch/nn/dropout.py",
            "deeplearning4j_tpu_torch/nn/weightnoise.py",
            "deeplearning4j_tpu_torch/nn/constraints.py",
            "deeplearning4j_tpu_torch/nn/tick.py",
            "deeplearning4j_tpu_torch/datasets/iterators.py",
            "deeplearning4j_tpu_torch/datasets/normalizers.py"} <= names


def test_decode_and_graph_persistence_modules_leave_jax_unloaded(tmp_path):
    """The decode slice's modules (the KV-cache and positional carries,
    the graph with carries and TBPTT, graph configuration serde and
    vertices, the graph zip, generation) import no jax, and a graph zip
    restores on the CPU only when the caller asks for it."""
    code = ("import sys, deeplearning4j_tpu_torch.nn.layers.attention, "
            "deeplearning4j_tpu_torch.nn.layers.core, "
            "deeplearning4j_tpu_torch.nn.layers.recurrent, "
            "deeplearning4j_tpu_torch.nn.graph, "
            "deeplearning4j_tpu_torch.nn.conf.graph_conf, "
            "deeplearning4j_tpu_torch.nn.vertices, "
            "deeplearning4j_tpu_torch.util.model_serializer, "
            "deeplearning4j_tpu_torch.zoo; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_computation_graph,
        restore_model,
    )
    from deeplearning4j_tpu_torch.zoo import TransformerLM, generate_on_device

    net = TransformerLM(vocab_size=10, max_length=8, n_layers=1, d_model=16,
                        n_heads=2, d_ff=32).init(device="cpu")
    path = os.path.join(str(tmp_path), "g.zip")
    net.save(path)
    for restore in (ComputationGraph.load, restore_computation_graph,
                    restore_model):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            restore(path)
    back = ComputationGraph.load(path, device="cpu")
    assert all(p.device.type == "cpu" for p in back.parameters())
    toks = generate_on_device(back, np.zeros((1, 3), np.float32), 4,
                              check_no_sync=True)
    assert toks.shape == (1, 4)


def test_normalization_zoo_and_import_modules_leave_jax_unloaded(tmp_path):
    """The ResNet and DL4J-import slice's modules (the norm, conv, pooling
    and core layers, every vertex, layer state in both networks and the
    train step, the zoo's helpers, the zip and converters with states, the
    DL4J reader, its ND4J and normalizer streams) import no jax, and the
    DL4J ``restore_*`` functions refuse to guess a device."""
    modules = ("nn.layers.norm", "nn.layers.conv", "nn.layers.pooling",
               "nn.layers.core", "nn.layers.base", "nn.vertices",
               "nn.conf.graph_conf", "nn.conf.preprocessors", "nn.graph",
               "nn.multilayer", "nn.train_step", "zoo.helpers", "zoo.models",
               "util.convert", "util.model_serializer", "modelimport",
               "modelimport.dl4j", "modelimport.nd4j_binary",
               "modelimport.normalizer_serde")
    code = ("import sys, " + ", ".join(f"deeplearning4j_tpu_torch.{m}"
                                       for m in modules)
            + "; bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'deeplearning4j_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    names = {os.path.relpath(p, REPO) for p in _port_files()}
    assert {f"deeplearning4j_tpu_torch/{m.replace('.', '/')}.py"
            for m in modules if m != "modelimport"} <= names
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    from deeplearning4j_tpu_torch.modelimport.dl4j import (
        restore_computation_graph,
        restore_multi_layer_network,
        restore_multi_layer_network_configuration,
    )
    from deeplearning4j_tpu_torch.zoo import ResNet50

    fixtures = os.path.join(REPO, "tests", "fixtures")
    mln = os.path.join(fixtures, "dl4j_checkpoint_convnet.zip")
    graph = os.path.join(fixtures, "dl4j_checkpoint_graph.zip")
    for restore, path in ((restore_multi_layer_network, mln),
                          (restore_multi_layer_network_configuration, mln),
                          (restore_computation_graph, graph)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            restore(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResNet50(num_labels=10, input_shape=(3, 32, 32)).init()
    net = restore_multi_layer_network(mln, device="cpu")
    assert all(t.device.type == "cpu" for s in net.states.values()
               for t in s.values())
    assert restore_computation_graph(graph, device="cpu").params["a"]["W"].device.type == "cpu"


def test_import_export_modules_leave_jax_keras_and_h5py_unloaded(tmp_path):
    """The model-import slice's modules (the Keras import, the DL4J export,
    the model guesser, the zoo's last models) import no jax, and neither
    h5py nor Keras until a file is read; their entry points refuse to
    guess a device."""
    modules = ("modelimport.keras", "modelimport.keras.hdf5", "modelimport.keras.layers",
               "modelimport.keras.model", "modelimport.keras.importer",
               "modelimport.dl4j_export", "util.model_guesser", "zoo.helpers", "zoo.models")
    code = ("import sys, " + ", ".join(f"deeplearning4j_tpu_torch.{m}" for m in modules)
            + "; bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'deeplearning4j_tpu', 'h5py', 'keras', 'tensorflow')]; "
              "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    names = {os.path.relpath(p, REPO) for p in _port_files()}
    assert {f"deeplearning4j_tpu_torch/{m.replace('.', '/')}.py"
            for m in modules if m != "modelimport.keras"} <= names
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    import json

    from deeplearning4j_tpu_torch.modelimport.dl4j_export import export_multi_layer_network
    from deeplearning4j_tpu_torch.modelimport.keras import KerasModelImport
    from deeplearning4j_tpu_torch.util.model_guesser import load_model_guess
    from deeplearning4j_tpu_torch.zoo import FaceNetNN4Small2, InceptionResNetV1, LeNet

    with open(os.path.join(REPO, "tests", "fixtures", "keras", "sequential_cnn.json")) as f:
        fixture = json.load(f)
    wrapper = KerasModelImport.import_keras_model_from_json(
        fixture["model_config"], fixture["training_config"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wrapper.init()
    net = wrapper.init(device="cpu")
    assert all(p.device.type == "cpu" for p in net.parameters())
    for model in (InceptionResNetV1(input_shape=(3, 75, 75)), FaceNetNN4Small2()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.init()
    path = os.path.join(str(tmp_path), "lenet_dl4j.zip")
    export_multi_layer_network(LeNet(input_shape=(1, 12, 12)).init(device="cpu"), path)
    with pytest.raises(Exception, match="no CUDA device"):
        load_model_guess(path)
    assert type(load_model_guess(path, device="cpu")).__name__ == "MultiLayerNetwork"


def test_nlp_and_native_modules_leave_jax_unloaded():
    """The NLP slice's modules (``nlp/`` but ``distributed.py``, ``native/``
    and the lookup-table carry) import no jax."""
    modules = ("nlp", "nlp.tokenization", "nlp.text_utils", "nlp.stemming",
               "nlp.dictionary_tokenizer", "nlp.language_packs", "nlp.sentence",
               "nlp.sentiment", "nlp.trees", "nlp.movingwindow", "nlp.vocab",
               "nlp.vectorizer", "nlp.lookup", "nlp.learning", "nlp.sequencevectors",
               "nlp.word2vec", "nlp.paragraph_vectors", "nlp.glove", "nlp.serializer",
               "nlp.cnn_sentence", "native", "native.codec", "native.loader",
               "util.convert")
    code = ("import sys, " + ", ".join(f"deeplearning4j_tpu_torch.{m}" for m in modules)
            + "; bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'deeplearning4j_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    names = {os.path.relpath(p, REPO) for p in _port_files()}
    assert {f"deeplearning4j_tpu_torch/{m.replace('.', '/')}.py"
            for m in modules if m not in ("nlp", "native")} <= names
    assert "deeplearning4j_tpu_torch/nlp/distributed.py" not in names


def test_graph_clustering_and_plot_modules_leave_jax_unloaded():
    """The graph embeddings, clustering and t-SNE slice's modules and the
    graph lookup-table carry import no jax."""
    modules = ("graph", "graph.api", "graph.graph", "graph.huffman", "graph.iterator",
               "graph.loader", "graph.deepwalk", "graph.node2vec", "graph.serializer",
               "clustering", "clustering.vptree", "clustering.kdtree", "clustering.sptree",
               "clustering.quadtree", "clustering.bruteforce", "clustering.cluster",
               "clustering.kmeans", "clustering.lsh", "clustering.server", "plot",
               "plot.tsne", "util.convert")
    code = ("import sys, " + ", ".join(f"deeplearning4j_tpu_torch.{m}" for m in modules)
            + "; from deeplearning4j_tpu_torch.util.convert import "
              "load_reference_graph_lookup_table; "
              "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'deeplearning4j_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    names = {os.path.relpath(p, REPO) for p in _port_files()}
    assert {f"deeplearning4j_tpu_torch/{m.replace('.', '/')}.py"
            for m in modules if m not in ("graph", "clustering", "plot")} <= names
    assert {f"deeplearning4j_tpu_torch/{m}/__init__.py"
            for m in ("graph", "clustering", "plot")} <= names


def test_serving_and_observability_modules_leave_jax_unloaded(tmp_path):
    """The tracing, supervision and model-registry slice's modules import no
    jax; the registry's path loads refuse to guess a device."""
    modules = ("observe", "observe.trace", "observe.export", "observe.buildhook",
               "observe.log", "observe.cost", "parallel.time_source",
               "parallel.elastic", "parallel.inference", "util.faultinject",
               "util.compile_cache", "serving", "serving.quantize",
               "serving.breaker", "serving.registry")
    code = ("import sys, " + ", ".join(f"deeplearning4j_tpu_torch.{m}" for m in modules)
            + "; from deeplearning4j_tpu_torch.observe import enable_tracing; "
              "enable_tracing(jax_hook=True); "
              "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'deeplearning4j_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    names = {os.path.relpath(p, REPO) for p in _port_files()}
    assert {f"deeplearning4j_tpu_torch/{m.replace('.', '/')}.py"
            for m in modules if m not in ("observe", "serving")} <= names
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    from deeplearning4j_tpu_torch.serving import ModelRegistry
    from deeplearning4j_tpu_torch.zoo import LeNet

    path = os.path.join(str(tmp_path), "lenet.zip")
    LeNet(input_shape=(1, 12, 12)).init(device="cpu").save(path)
    with pytest.raises(Exception, match="no CUDA device"):
        ModelRegistry.load(path)
    reg = ModelRegistry(warmup="off")
    try:
        with pytest.raises(Exception, match="no CUDA device"):
            reg.register("lenet", path=path)
        assert not reg.has("lenet")
        assert reg.register("lenet", path=path, device="cpu") == 1
        assert reg.get("lenet").versions[1].model.device.type == "cpu"
    finally:
        reg.shutdown()
    assert ModelRegistry.load(path, device="cpu").device.type == "cpu"
