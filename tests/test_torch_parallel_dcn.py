"""The port's cross-slice gradient bridge (``parallel/dcn.py``): the JAX
package's ``tests/test_dcn.py`` cases in one process, on networks that
start from the reference's initial parameters, and frames crossing
between the packages both ways: a frame of the reference's bridge
applied by the port's, and the reverse, leave the same parameters within
1e-6."""

from __future__ import annotations

import time

import jax
import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
from deeplearning4j_tpu.parallel.dcn import CrossSliceGradientBridge as JBridge
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Sgd
from deeplearning4j_tpu_torch.parallel.dcn import CrossSliceGradientBridge
from deeplearning4j_tpu_torch.streaming import EmbeddedBroker, SocketConsumer, SocketPublisher
from deeplearning4j_tpu_torch.util import convert


def j_net(seed):
    conf = (JNNC.builder().seed(seed).updater(JSgd(0.1)).list()
            .layer(JDense(n_out=12, activation="tanh"))
            .layer(JOut(n_out=3))
            .set_input_type(JIT.feed_forward(6)).build())
    return JMLN(conf).init()


def _net(seed):
    """The reference test's network on the port, from the reference's
    initial parameters of the same seed."""
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(0.1)).list()
            .layer(DenseLayer(n_out=12, activation="tanh"))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(6)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    convert.load_reference_params(net, jax.tree_util.tree_map(np.asarray, j_net(seed).params))
    return net


def _data(n, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    x[np.arange(n), y] += 2.5
    return DataSet(x, np.eye(3, dtype=np.float32)[y])


def host_params(net):
    return convert.export_params(net)


class _BrokerEndpoint:
    """publish/poll over one EmbeddedBroker topic."""

    def __init__(self, broker, topic, group):
        self.broker, self.topic, self.group = broker, topic, group
        broker.subscribe(topic, group)

    def publish(self, payload):
        self.broker.publish(self.topic, payload)

    def poll(self, timeout=0.0):
        return self.broker.poll(self.topic, self.group, timeout=timeout or 0.01)


class TestCrossSliceBridge:
    def test_two_slices_converge_together(self):
        """Each slice trains on its own half of the data; through the
        bridge both learn the whole distribution and stay close."""
        broker = EmbeddedBroker()
        end_a = _BrokerEndpoint(broker, "grads", "a")
        end_b = _BrokerEndpoint(broker, "grads", "b")
        bridge_a = CrossSliceGradientBridge(end_a, end_a, threshold=5e-4, slice_id="A")
        bridge_b = CrossSliceGradientBridge(end_b, end_b, threshold=5e-4, slice_id="B")
        net_a, net_b = _net(1), _net(1)
        full = _data(512, seed=0)
        da = DataSet(full.features[:256], full.labels[:256])
        db = DataSet(full.features[256:], full.labels[256:])
        for _ in range(30):
            net_a.fit(da)
            net_b.fit(db)
            bridge_a.publish_update(net_a.params)
            bridge_b.publish_update(net_b.params)
            params, _ = bridge_a.poll_and_apply(net_a.params)
            assert params is net_a.params  # applied in place
            bridge_b.poll_and_apply(net_b.params)
        assert net_a.evaluate(ListDataSetIterator(db, 256)).accuracy() > 0.85
        assert net_b.evaluate(ListDataSetIterator(da, 256)).accuracy() > 0.85
        for la, lb in zip(host_params(net_a), host_params(net_b)):
            for k in la:
                diff = float(np.max(np.abs(la[k] - lb[k])))
                assert diff < 0.5, f"replicas diverged on {k}: {diff}"

    def test_socket_transport_between_bridges(self):
        cons_a, cons_b = SocketConsumer(), SocketConsumer()
        pub_to_b = SocketPublisher("127.0.0.1", cons_b.port)
        pub_to_a = SocketPublisher("127.0.0.1", cons_a.port)
        try:
            bridge_a = CrossSliceGradientBridge(pub_to_b, cons_a, threshold=1e-3, slice_id="A")
            bridge_b = CrossSliceGradientBridge(pub_to_a, cons_b, threshold=1e-3, slice_id="B")
            net_a, net_b = _net(1), _net(1)
            ds = _data(128, seed=1)
            for _ in range(5):
                net_a.fit(ds)
                bridge_a.publish_update(net_a.params)
            time.sleep(0.2)
            before = [v.clone() for v in net_b.params[0].values()]
            _, applied = bridge_b.poll_and_apply(net_b.params, timeout=1.0)
            assert applied >= 1
            after = list(net_b.params[0].values())
            assert any(not np.allclose(b.numpy(), a.numpy()) for b, a in zip(before, after))
        finally:
            pub_to_a.close()
            pub_to_b.close()
            cons_a.close()
            cons_b.close()

    def test_dense_fallback_when_sparse_overflows(self):
        broker = EmbeddedBroker()
        a = _BrokerEndpoint(broker, "d", "ga")
        b = _BrokerEndpoint(broker, "d", "gb")
        bridge_a = CrossSliceGradientBridge(a, a, threshold=1e-8, capacity_fraction=0.01,
                                            slice_id="A")
        bridge_b = CrossSliceGradientBridge(b, b, threshold=1e-8, slice_id="B")
        net_a, net_b = _net(1), _net(1)
        bridge_a.publish_update(net_a.params)  # the baseline: nothing moved, no frame
        bridge_b.poll_and_apply(net_b.params)
        before = host_params(net_b)
        net_a.fit(_data(64, seed=4))
        assert bridge_a.publish_update(net_a.params) > 0
        _, applied = bridge_b.poll_and_apply(net_b.params, timeout=0.5)
        assert applied == 1
        assert any(not np.allclose(o[k], n[k])
                   for o, n in zip(before, host_params(net_b)) for k in o)
        # layer 0's W (72 entries, capacity 16) went dense: its residual is flushed
        assert float(np.abs(bridge_a._residual[0]["W"]).sum()) < 1e-6

    def test_malformed_frame_skipped(self):
        broker = EmbeddedBroker()
        a = _BrokerEndpoint(broker, "m", "ga")
        b = _BrokerEndpoint(broker, "m", "gb")
        bridge_a = CrossSliceGradientBridge(a, a, threshold=1e-8, capacity_fraction=0.01,
                                            slice_id="A")
        bridge_b = CrossSliceGradientBridge(b, b, threshold=1e-8, slice_id="B")
        net_a, net_b = _net(1), _net(1)
        bridge_a.publish_update(net_a.params)
        net_a.fit(_data(64, seed=6))
        bridge_a.publish_update(net_a.params)
        frame = b.broker.poll("m", "gb", timeout=0.5)
        assert frame is not None
        b.broker.publish("m", frame[:-5])          # truncated in flight
        b.broker.publish("m", b"\x00\x00\x00\x02{}")  # garbage
        before = host_params(net_b)
        _, applied = bridge_b.poll_and_apply(net_b.params, timeout=0.2)
        assert applied == 0
        for o, n in zip(before, host_params(net_b)):
            for k in o:
                np.testing.assert_array_equal(o[k], n[k])

    def test_no_frame_when_nothing_passes(self):
        broker = EmbeddedBroker()
        end = _BrokerEndpoint(broker, "e", "g")
        bridge = CrossSliceGradientBridge(end, end, threshold=1e6, slice_id="Z")
        net = _net(5)
        assert bridge.publish_update(net.params) == 0
        assert end.poll(timeout=0.05) is None

    def test_residual_carries_subthreshold_mass(self):
        broker = EmbeddedBroker()
        end = _BrokerEndpoint(broker, "t", "g")
        bridge = CrossSliceGradientBridge(end, end, threshold=1e6, slice_id="X")
        net = _net(2)
        bridge.publish_update(net.params)
        ds = _data(64, seed=3)
        net.fit(ds)
        bridge.publish_update(net.params)
        total = sum(float(np.abs(r).sum()) for layer in bridge._residual.values()
                    for r in layer.values())
        assert total > 0
        net.fit(ds)
        bridge.publish_update(net.params)
        total2 = sum(float(np.abs(r).sum()) for layer in bridge._residual.values()
                     for r in layer.values())
        assert total2 > total


class _Capture:
    """A publisher that keeps the frames; a consumer that hands out a list."""

    def __init__(self, frames=None):
        self.frames = [] if frames is None else list(frames)

    def publish(self, payload):
        self.frames.append(payload)

    def poll(self, timeout=0.0):
        return self.frames.pop(0) if self.frames else None


@pytest.mark.parametrize("sender", ["reference", "port"])
def test_frames_cross_between_the_packages(sender):
    """Both senders move the same net alike (the port's sparse section and
    a dense one: layer 0's W overflows a capacity of 1%); the frame of
    one package's bridge, applied by the other's, gives the parameters
    the receiving package's own bridge gives from its own frame."""
    ds = _data(64, seed=4)
    jn, tn = j_net(1), _net(1)
    kw = dict(threshold=1e-3, capacity_fraction=0.2)
    jb, tb = JBridge(_Capture(), _Capture(), slice_id="A", **kw), \
        CrossSliceGradientBridge(_Capture(), _Capture(), slice_id="A", **kw)
    jb.publish_update(jn.params)
    tb.publish_update(tn.params)
    jn.fit(JDataSet(ds.features, ds.labels))
    tn.fit(ds)
    assert jb.publish_update(jn.params) > 0 and tb.publish_update(tn.params) > 0
    j_frame, t_frame = jb.publisher.frames[-1], tb.publisher.frames[-1]
    frame = j_frame if sender == "reference" else t_frame

    # the port receiving either frame, against the port receiving its own
    got_net, own_net = _net(7), _net(7)
    for net, fr in ((got_net, frame), (own_net, t_frame)):
        rb = CrossSliceGradientBridge(_Capture(), _Capture([fr]), slice_id="B", **kw)
        _, applied = rb.poll_and_apply(net.params)
        assert applied == 1
    for a, b in zip(host_params(got_net), host_params(own_net)):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)

    # the reference receiving either frame, against its own
    got, own = j_net(7), j_net(7)
    for net, fr in ((got, frame), (own, j_frame)):
        rb = JBridge(_Capture(), _Capture([fr]), slice_id="B", **kw)
        net.params, applied = rb.poll_and_apply(net.params)
        assert applied == 1
    for la, lb in zip(got.params, own.params):
        for k in la:
            np.testing.assert_allclose(np.asarray(la[k]), np.asarray(lb[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
    # and the two packages' receivers agree with each other
    for a, b in zip(host_params(got_net), got.params):
        for k in a:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=0, atol=1e-6, err_msg=k)
