"""The port's streaming routes, broker, sockets, streaming iterator and
Kafka client against the JAX package's on the CPU.

Both packages' ``Route`` run the same sources through the same transforms,
filters and sinks: the delivered items, counts, error lists, the
``RouteError``'s item, a background route's ``result`` / ``error`` and a
join's ``TimeoutError`` are equal, and under an active tracer the spans
have the same names in the same order. The codec's frames of the same
arrays and DataSets are byte for byte equal; the port's ``SocketPublisher``
feeds the reference's ``SocketConsumer`` and the other way round over
loopback (port 0, closed in ``finally``), each side reading the other's
frames unchanged. The port's ``StreamingDataSetIterator`` yields the
reference-encoded batches unchanged from a broker topic and from a
socket. ``NDArrayKafkaClient`` without ``kafka-python`` takes the embedded
broker in both, and both refuse a bootstrap server with the same message.
"""

import threading

import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import DataSet as RDataSet
from deeplearning4j_tpu.observe import trace as r_trace
from deeplearning4j_tpu.streaming import broker as r_broker
from deeplearning4j_tpu.streaming import codec as r_codec
from deeplearning4j_tpu.streaming import kafka as r_kafka
from deeplearning4j_tpu.streaming import route as r_route
from deeplearning4j_tpu_torch import streaming as P
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as PDataSet
from deeplearning4j_tpu_torch.observe import trace as p_trace
from deeplearning4j_tpu_torch.streaming import broker as p_broker
from deeplearning4j_tpu_torch.streaming import codec as p_codec
from deeplearning4j_tpu_torch.streaming import kafka as p_kafka
from deeplearning4j_tpu_torch.streaming import route as p_route

PACKAGES = {"port": (p_route, p_broker, p_codec, p_kafka, p_trace, PDataSet),
            "reference": (r_route, r_broker, r_codec, r_kafka, r_trace, RDataSet)}


def both(fn):
    """``fn(*package)`` for the port and the reference."""
    return fn(*PACKAGES["port"]), fn(*PACKAGES["reference"])


def double(x):
    return 2 * x


def not_third(x):
    return x % 3 != 0


def boom_at_4(x):
    if x == 4:
        raise ValueError("four")
    return x


ROUTES = {
    "transform_filter_list": lambda R: R.Route().from_source(range(10))
    .transform(double).filter(not_third),
    "filter_then_transform": lambda R: R.Route().from_source(range(7))
    .filter(not_third).transform(double).transform(double),
    "empty_source": lambda R: R.Route().from_source([]).transform(double),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
@pytest.mark.parametrize("background", [False, True])
def test_route_delivers_the_reference_s_items(name, background):
    def run(R, *_):
        out = []
        route = ROUTES[name](R).to_list(out)
        if background:
            n = route.start().join(timeout=10)
            return n, out, route.result, route.error
        return route.run(), out, route.result, route.error

    port, ref = both(run)
    assert port == ref


@pytest.mark.parametrize("policy", ["skip", "handler"])
def test_route_error_policies_as_the_reference(policy):
    def run(R, *_):
        out, seen = [], []
        handler = "skip" if policy == "skip" else (lambda item, e: seen.append((item, str(e))))
        route = (R.Route().from_source(range(8)).transform(boom_at_4)
                 .on_error(handler).to_list(out))
        n = route.run()
        return n, out, [(i, str(e)) for i, e in route.errors], seen

    port, ref = both(run)
    assert port == ref and port[0] == 7 and port[2] == [(4, "four")]


def test_route_stop_policy_raises_route_error_with_the_item():
    def run(R, *_):
        out = []
        route = R.Route().from_source(range(8)).transform(boom_at_4).to_list(out)
        with pytest.raises(R.RouteError) as e:
            route.run()
        bg = R.Route().from_source(range(8)).transform(boom_at_4).to_list([]).start()
        got = bg.join(timeout=10)
        failing = (R.Route().from_source(range(8)).transform(boom_at_4)
                   .on_error(lambda item, exc: 1 / 0).to_list([]))
        with pytest.raises(R.RouteError) as f:
            failing.run()
        return (e.value.item, str(e.value), out, got, type(bg.error).__name__,
                bg.error.item, f.value.item, type(f.value.__cause__).__name__)

    port, ref = both(run)
    assert port == ref and port[0] == 4


def test_route_refusals_and_join_timeout():
    def run(R, *_):
        errors = []
        with pytest.raises(ValueError) as e:
            R.Route().from_source([1]).run()
        errors.append(str(e.value))
        with pytest.raises(ValueError) as e:
            R.Route().on_error("ignore")
        errors.append(str(e.value))
        release = threading.Event()

        def slow():
            yield 1
            release.wait(10)
            yield 2

        out = []
        route = R.Route().from_source(slow()).to_list(out).start()
        with pytest.raises(TimeoutError) as e:
            route.join(timeout=0.05)
        errors.append(str(e.value))
        release.set()
        return errors, route.join(timeout=10), out

    port, ref = both(run)
    assert port == ref


def test_route_spans_as_the_reference():
    def run(R, B, C, K, T, D):
        tracer = T.enable_tracing()
        try:
            R.Route().from_source(range(4)).transform(double).filter(not_third) \
                .to_list([]).run()
        finally:
            T.disable_tracing()
        return [(s.name, s.category) for s in sorted(tracer.recorder.spans(),
                                                     key=lambda s: s.start_ns)]

    port, ref = both(run)
    assert port == ref and port[0] == ("route.run", "stream")


def datasets(n, masks):
    rng = np.random.default_rng(n)
    out = []
    for i in range(n):
        x = rng.normal(size=(3, 5, 4)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (3, 5))]
        fm = (rng.random((3, 5)) > 0.3).astype(np.float32) if masks else None
        lm = (rng.random((3, 5)) > 0.3).astype(np.float32) if masks else None
        out.append((x, y, fm, lm))
    return out


ARRAYS = [np.arange(12, dtype=np.float32).reshape(3, 4), np.arange(5, dtype=np.int64),
          np.array(3.5, dtype=np.float64), np.zeros((2, 0, 3), np.float32),
          (np.arange(6) % 2).astype(bool).reshape(2, 3), np.arange(8, dtype=np.uint8)]


@pytest.mark.parametrize("i", range(len(ARRAYS)))
def test_array_frames_equal_the_reference_s_bytes(i):
    a = ARRAYS[i]
    frame = p_codec.serialize_array(a)
    assert frame == r_codec.serialize_array(a)
    back = p_codec.deserialize_array(r_codec.serialize_array(a))
    want = r_codec.deserialize_array(frame)  # a 0-d array comes back as [1] in both
    assert back.dtype == want.dtype == a.dtype and back.shape == want.shape
    assert np.array_equal(back, want) and np.array_equal(back.reshape(a.shape), a)


@pytest.mark.parametrize("masks", [False, True])
def test_dataset_frames_equal_the_reference_s_bytes(masks):
    for x, y, fm, lm in datasets(3, masks):
        frame = p_codec.serialize_dataset(PDataSet(x, y, fm, lm))
        assert frame == r_codec.serialize_dataset(RDataSet(x, y, fm, lm))
        ds = p_codec.deserialize_dataset(frame)
        for got, want in ((ds.features, x), (ds.labels, y),
                          (ds.features_mask, fm), (ds.labels_mask, lm)):
            assert (got is None and want is None) or np.array_equal(got, want)


def test_embedded_broker_groups_as_the_reference():
    def run(R, B, *_):
        broker = B.EmbeddedBroker()
        broker.subscribe("t", "a")
        broker.subscribe("t", "b")
        for i in range(3):
            broker.publish("t", bytes([i]))
        broker.publish("u", b"x")  # no subscriber yet: the default group
        got = {g: [broker.poll("t", g, timeout=1) for _ in range(3)] for g in "ab"}
        return (got, broker.poll("t", "a", timeout=0.01), broker.poll("u", timeout=1),
                broker.poll("t", "late", timeout=0.01))

    port, ref = both(run)
    assert port == ref and port[0]["a"] == [b"\x00", b"\x01", b"\x02"]


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_socket_frames_cross_between_the_packages(direction):
    pub_mod, con_mod = ((p_broker, r_broker) if direction == "port_to_reference"
                        else (r_broker, p_broker))
    frames = [p_codec.serialize_dataset(PDataSet(x, y, fm, lm))
              for x, y, fm, lm in datasets(4, True)] + [b"", bytes(70000)]
    consumer = con_mod.SocketConsumer(port=0)
    publisher = None
    try:
        publisher = pub_mod.SocketPublisher("127.0.0.1", consumer.port)
        for f in frames:
            publisher.publish(f)
        got = [consumer.poll(timeout=10) for _ in frames]
        assert consumer.poll(timeout=0.05) is None
    finally:
        if publisher is not None:
            publisher.close()
        consumer.close()
    assert got == frames


def test_streaming_iterator_yields_reference_frames_from_a_topic():
    batches = datasets(5, True)
    broker = P.EmbeddedBroker()
    for x, y, fm, lm in batches:
        broker.publish("train", r_codec.serialize_dataset(RDataSet(x, y, fm, lm)))
    it = P.StreamingDataSetIterator(broker, topic="train", num_batches=3, poll_timeout=1)
    first = list(it)
    it.reset()  # a stream does not rewind
    rest = list(P.StreamingDataSetIterator(broker, topic="train", poll_timeout=0.05))
    got = first + rest
    assert len(first) == 3 and len(got) == 5
    for ds, (x, y, fm, lm) in zip(got, batches):
        assert isinstance(ds, PDataSet)
        for a, b in ((ds.features, x), (ds.labels, y), (ds.features_mask, fm),
                     (ds.labels_mask, lm)):
            assert np.array_equal(a, b)


def test_streaming_iterator_over_a_socket_feeds_fit():
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(8, 4)).astype(np.float32) for _ in range(3)]
    ys = [np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)] for _ in range(3)]
    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(DenseLayer(n_out=6, activation="tanh")).layer(OutputLayer(n_out=2))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    twin = net.clone()
    consumer = P.SocketConsumer(port=0)
    publisher = None
    try:
        publisher = r_broker.SocketPublisher("127.0.0.1", consumer.port)
        for x, y in zip(xs, ys):
            publisher.publish(r_codec.serialize_dataset(RDataSet(x, y)))
        net.fit(P.StreamingDataSetIterator(consumer, num_batches=3, poll_timeout=10))
    finally:
        if publisher is not None:
            publisher.close()
        consumer.close()
    for x, y in zip(xs, ys):
        twin.fit(PDataSet(x, y))
    assert net.iteration == twin.iteration == 3
    for k in twin.params:
        for n in twin.params[k]:
            assert np.array_equal(net.params[k][n].numpy(), twin.params[k][n].numpy())


def test_kafka_client_without_kafka_as_the_reference(monkeypatch):
    monkeypatch.setattr(p_kafka, "_kafka_available", lambda: False)
    monkeypatch.setattr(r_kafka, "_kafka_available", lambda: False)

    def run(R, B, C, K, *_):
        client = K.NDArrayKafkaClient(topic="arrays")
        for a in ARRAYS[:3]:
            client.publish(a)
        got = [client.poll(timeout=1) for _ in range(3)]
        shared = B.EmbeddedBroker()
        sender = K.NDArrayKafkaClient(topic="t", embedded=shared)
        receiver = K.NDArrayKafkaClient(topic="t", embedded=shared)
        sender.publish(ARRAYS[0])
        with pytest.raises(ImportError) as e:
            K.NDArrayKafkaClient(bootstrap_servers="localhost:9092")
        return ([(g.dtype.str, g.shape, g.tobytes()) for g in got],
                client.poll(timeout=0.01), receiver.poll(timeout=1).tobytes(), str(e.value))

    port, ref = both(run)
    assert port == ref


def test_streaming_exports_the_reference_s_names():
    import deeplearning4j_tpu.streaming as R

    names = {n for n in dir(R) if not n.startswith("_")} - {
        "broker", "codec", "kafka", "route"}
    assert names <= set(dir(P))
