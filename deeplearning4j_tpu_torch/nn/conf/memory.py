"""Memory reports: analytic per-layer forecasts and one measured step.

Counterpart of ``deeplearning4j_tpu/nn/conf/memory.py`` (DL4J's
``nn/conf/memory/``: ``MemoryReport``, ``LayerMemoryReport``,
``NetworkMemoryReport``, ``MemoryType``, ``MemoryUseMode``): analytic,
pre-run forecasts of parameter, gradient, updater-state and activation
memory per layer and per network, JSON both ways, with the reference's
numbers.

:func:`compiled_memory_analysis` keeps the reference's name and keys. The
reference reads XLA's buffer assignment of its compiled training step;
eager PyTorch compiles no step, so on a CUDA network the port measures one
real training step on copies of the parameters and the updater state
(the peak of ``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``). On a CPU network it returns ``{}``, the
reference's answer for a backend without memory analysis.
"""

from __future__ import annotations

import enum
import json
from typing import Dict, List

class MemoryType(enum.Enum):
    """What a block of memory is used for (``MemoryType.java``)."""

    PARAMETERS = "parameters"
    PARAMETER_GRADIENTS = "parameter_gradients"
    ACTIVATIONS = "activations"
    ACTIVATION_GRADIENTS = "activation_gradients"
    UPDATER_STATE = "updater_state"
    WORKING_MEMORY_FIXED = "working_memory_fixed"
    WORKING_MEMORY_VARIABLE = "working_memory_variable"

    def is_inference(self) -> bool:
        """Types that exist during inference as well as training
        (``MemoryType.java:16-25``)."""
        return self in (MemoryType.PARAMETERS, MemoryType.ACTIVATIONS,
                        MemoryType.WORKING_MEMORY_FIXED,
                        MemoryType.WORKING_MEMORY_VARIABLE)


class MemoryUseMode(enum.Enum):
    TRAINING = "training"
    INFERENCE = "inference"


# updater classname -> number of state copies of the params it keeps
_UPDATER_STATE_MULT = {
    "Sgd": 0, "NoOp": 0,
    "Nesterovs": 1, "AdaGrad": 1, "RmsProp": 1,
    "Adam": 2, "AdaMax": 2, "AdaDelta": 2, "Nadam": 2,
    "AMSGrad": 3,
}


def updater_state_multiplier(updater) -> int:
    return _UPDATER_STATE_MULT.get(type(updater).__name__, 2)


class LayerMemoryReport:
    """Per-layer memory forecast (``LayerMemoryReport.java``): fixed counts
    (params, updater state) and per-example counts (activations, working
    memory), in *elements*; byte totals computed against a minibatch size and
    dtype width."""

    def __init__(self, layer_name: str, layer_type: str, *, parameters: int = 0,
                 updater_state: int = 0, activations_per_ex: int = 0,
                 working_mem_fixed: int = 0, working_mem_per_ex: int = 0):
        self.layer_name = layer_name
        self.layer_type = layer_type
        self.parameters = int(parameters)
        self.updater_state = int(updater_state)
        self.activations_per_ex = int(activations_per_ex)
        self.working_mem_fixed = int(working_mem_fixed)
        self.working_mem_per_ex = int(working_mem_per_ex)

    def get_memory_elements(self, memory_type: MemoryType, minibatch: int,
                            mode: MemoryUseMode = MemoryUseMode.TRAINING) -> int:
        training = mode is MemoryUseMode.TRAINING
        if memory_type is MemoryType.PARAMETERS:
            return self.parameters
        if memory_type is MemoryType.PARAMETER_GRADIENTS:
            return self.parameters if training else 0
        if memory_type is MemoryType.ACTIVATIONS:
            return self.activations_per_ex * minibatch
        if memory_type is MemoryType.ACTIVATION_GRADIENTS:
            return self.activations_per_ex * minibatch if training else 0
        if memory_type is MemoryType.UPDATER_STATE:
            return self.updater_state if training else 0
        if memory_type is MemoryType.WORKING_MEMORY_FIXED:
            return self.working_mem_fixed
        if memory_type is MemoryType.WORKING_MEMORY_VARIABLE:
            return self.working_mem_per_ex * minibatch
        return 0

    def get_total_memory_bytes(self, minibatch: int,
                               mode: MemoryUseMode = MemoryUseMode.TRAINING,
                               bytes_per_element: int = 4) -> int:
        return sum(self.get_memory_elements(t, minibatch, mode)
                   for t in MemoryType) * bytes_per_element

    def to_dict(self) -> dict:
        return {"layer_name": self.layer_name, "layer_type": self.layer_type,
                "parameters": self.parameters,
                "updater_state": self.updater_state,
                "activations_per_ex": self.activations_per_ex,
                "working_mem_fixed": self.working_mem_fixed,
                "working_mem_per_ex": self.working_mem_per_ex}

    @staticmethod
    def from_dict(d: dict) -> "LayerMemoryReport":
        return LayerMemoryReport(d["layer_name"], d["layer_type"],
                                 parameters=d["parameters"],
                                 updater_state=d["updater_state"],
                                 activations_per_ex=d["activations_per_ex"],
                                 working_mem_fixed=d.get("working_mem_fixed", 0),
                                 working_mem_per_ex=d.get("working_mem_per_ex", 0))


class NetworkMemoryReport:
    """Whole-network forecast: aggregates layer reports
    (``NetworkMemoryReport.java:26``)."""

    def __init__(self, layer_reports: List[LayerMemoryReport], model_name: str,
                 input_elements_per_ex: int = 0, bytes_per_element: int = 4):
        self.layer_reports = list(layer_reports)
        self.model_name = model_name
        self.input_elements_per_ex = int(input_elements_per_ex)
        self.bytes_per_element = bytes_per_element

    def get_name(self) -> str:
        return self.model_name

    def get_memory_bytes(self, memory_type: MemoryType, minibatch: int,
                         mode: MemoryUseMode = MemoryUseMode.TRAINING) -> int:
        total = sum(r.get_memory_elements(memory_type, minibatch, mode)
                    for r in self.layer_reports)
        if memory_type is MemoryType.ACTIVATIONS:
            total += self.input_elements_per_ex * minibatch
        return total * self.bytes_per_element

    def get_total_memory_bytes(self, minibatch: int,
                               mode: MemoryUseMode = MemoryUseMode.TRAINING) -> int:
        return sum(self.get_memory_bytes(t, minibatch, mode) for t in MemoryType)

    def to_json(self) -> str:
        return json.dumps({
            "model_name": self.model_name,
            "bytes_per_element": self.bytes_per_element,
            "input_elements_per_ex": self.input_elements_per_ex,
            "layers": [r.to_dict() for r in self.layer_reports],
        })

    @staticmethod
    def from_json(s: str) -> "NetworkMemoryReport":
        d = json.loads(s)
        return NetworkMemoryReport(
            [LayerMemoryReport.from_dict(r) for r in d["layers"]],
            d["model_name"], d.get("input_elements_per_ex", 0),
            d.get("bytes_per_element", 4))

    def __str__(self) -> str:
        lines = [f"NetworkMemoryReport: {self.model_name} "
                 f"({len(self.layer_reports)} layers)"]
        header = f"  {'layer':<24}{'type':<26}{'params':>12}{'act/ex':>10}"
        lines.append(header)
        for r in self.layer_reports:
            lines.append(f"  {r.layer_name:<24}{r.layer_type:<26}"
                         f"{r.parameters:>12}{r.activations_per_ex:>10}")
        for mb in (1, 32):
            tot = self.get_total_memory_bytes(mb)
            lines.append(f"  total training memory @ batch {mb}: "
                         f"{tot / (1 << 20):.2f} MiB")
        return "\n".join(lines)


def network_memory_report(conf, model_name: str = "MultiLayerNetwork") -> NetworkMemoryReport:
    """A NetworkMemoryReport of a finalized MultiLayerConfiguration (the
    reference's ``getMemoryReport(InputType)``)."""
    import math

    bytes_per = 4 if conf.global_conf.dtype in ("float32",) else (
        8 if conf.global_conf.dtype == "float64" else 2)
    reports = []
    for i, l in enumerate(conf.layers):
        n_params = l.num_params()
        act = 0
        if conf.input_type is not None and conf.layer_input_types[i] is not None:
            out = l.output_type(conf.layer_input_types[i])
            act = int(math.prod(out.batch_shape(1)))
        upd = getattr(l, "updater", None) or conf.global_conf.updater
        mult = updater_state_multiplier(upd) if upd is not None else 0
        reports.append(LayerMemoryReport(
            l.name or f"layer{i}", type(l).__name__,
            parameters=n_params, updater_state=n_params * mult,
            activations_per_ex=act))
    in_elems = 0
    if conf.input_type is not None:
        in_elems = int(math.prod(conf.input_type.batch_shape(1)))
    return NetworkMemoryReport(reports, model_name, in_elems, bytes_per)


def _bytes(tree) -> int:
    """The bytes of every tensor of a nested dict."""
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def compiled_memory_analysis(net, batch: int = 32) -> Dict[str, int]:
    """The device memory of one training step of a ``MultiLayerNetwork`` at
    ``batch``, measured on the card: the reference's keys (bytes).

    - ``argument_size``: the parameters, the updater state, the features
      and the labels, counted from the tensors;
    - ``output_size``: the new parameters and updater state and the loss
      (the port writes the first two in place, so ``alias_size`` counts
      them again: the bytes the outputs share with the arguments);
    - ``temp_size``: the step's peak allocation above what was allocated
      when it started;
    - ``generated_code_size``: 0 (the kernels are loaded libraries);
    - ``total``: argument + output + temp + generated code, the
      reference's sum.

    The step runs a copy of the parameters and updater state through the
    network's loss, autograd and the updater seam (a registered
    ``FusedUpdaterHelper`` launches its kernel), from a copy of the
    dropout generator, so the network is left as it was. ``{}`` on a CPU
    network."""
    import torch

    from deeplearning4j_tpu_torch.nn.train_step import apply_updates, gradients

    if net.params is None:
        net.init()
    if getattr(net.conf, "input_type", None) is None:
        raise ValueError("compiled_memory_analysis requires the configuration "
                         "to have an input type (set_input_type(...)) so the "
                         "step has concrete shapes")
    if net.device.type != "cuda":
        return {}
    params = {k: {n: t.detach().clone() for n, t in named.items()}
              for k, named in net.params.items()}
    states = {k: {n: {s: t.clone() for s, t in st.items()} for n, st in named.items()}
              for k, named in net.updater_states.items()}
    x = torch.zeros(net.conf.input_type.batch_shape(batch), dtype=net.dtype,
                    device=net.device)
    y = torch.zeros(net.conf.output_type().batch_shape(batch), dtype=net.dtype,
                    device=net.device)
    gen = torch.Generator(device=net.device)
    gen.set_state(net.dropout_generator.get_state())
    arguments = _bytes(params) + _bytes(states) + _bytes(x) + _bytes(y)
    torch.cuda.synchronize(net.device)
    torch.cuda.reset_peak_memory_stats(net.device)
    base = torch.cuda.memory_allocated(net.device)
    loss, grads, _ = gradients(
        lambda live: net._loss_fn(live, x, y, None, None, train=True, gen=gen),
        params)
    apply_updates(params, grads, net._updaters, states, 0, 0, dict(net._named_layers()))
    torch.cuda.synchronize(net.device)
    temp = torch.cuda.max_memory_allocated(net.device) - base
    aliased = _bytes(params) + _bytes(states)
    out = {"argument_size": arguments, "output_size": aliased + _bytes(loss),
           "temp_size": int(temp), "alias_size": aliased, "generated_code_size": 0}
    out["total"] = (out["argument_size"] + out["output_size"]
                    + out["temp_size"] + out["generated_code_size"])
    return out
