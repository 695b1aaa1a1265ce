"""Inference surface of the port (counterpart of
``paddle_tpu.inference``): the reference's ``Config``, handles and
predictor factory, over the paged-KV serving engine.

``create_predictor(Config(path).enable_llm_engine(...))`` on a llama
serving artifact (``serving.save_llama_artifact`` output, detected by its
``.llamacfg.json``) returns an :class:`LLMEnginePredictor`: the artifact
loaded by ``serving.load_llama_artifact`` and served by
``serving.LLMEngine``, on ``cuda:<device_id>`` (``Config.disable_gpu()``:
the CPU). The reference's StableHLO :class:`Predictor` and
:func:`convert_to_mixed_precision` replay ``jit.save`` programs, which the
port does not have: they raise ``NotImplementedError`` (ROADMAP Queue 1,
item 3, ``jit/``), as ``create_predictor`` does for any other artifact.
Graph-level knobs (``switch_ir_optim``, ``enable_memory_optim``, ...) are
recorded for parity.
"""

from __future__ import annotations

import os

import numpy as np

from . import serving

__all__ = ["Config", "Predictor", "Tensor", "create_predictor",
           "PrecisionType", "PlaceType", "get_version",
           "LLMEnginePredictor", "serving", "DataType",
           "get_num_bytes_of_data_type", "get_trt_compile_version",
           "get_trt_runtime_version", "convert_to_mixed_precision",
           "XpuConfig", "PredictorPool", "_get_phi_kernel_name"]

_NO_JIT = ("the StableHLO predictor replays jit.save programs, and jit.save "
           "is not ported yet (ROADMAP Queue 1, item 3, jit/)")


class PrecisionType:
    Float32 = "float32"
    Half = "float16"
    Bfloat16 = "bfloat16"
    Int8 = "int8"


class PlaceType:
    CPU = "cpu"
    GPU = "gpu"
    XPU = "xpu"
    CUSTOM = "custom"
    TPU = "tpu"


def get_version():
    from .. import __version__

    return __version__


class Config:
    """reference analysis_config — model path + device/precision options."""

    def __init__(self, prog_file=None, params_file=None, model_dir=None):
        if model_dir is not None and prog_file is None:
            prog_file = os.path.join(model_dir, "model")
        self._prog_file = prog_file
        self._params_file = params_file
        self._device = None  # None = the card
        self._device_id = 0
        self._precision = PrecisionType.Float32
        self._ir_optim = True
        self._memory_optim = True
        self._cpu_math_threads = 1
        self._enable_profile = False
        self._llm_engine = False
        self._llm_engine_kwargs = {}

    # ---- model paths ----------------------------------------------------
    def set_model(self, prog_file, params_file=None):
        self._prog_file = prog_file
        self._params_file = params_file

    def prog_file(self):
        return self._prog_file

    def params_file(self):
        return self._params_file

    # ---- device ---------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       precision=PrecisionType.Float32):
        self._device = None
        self._device_id = device_id
        self._precision = precision

    def enable_xpu(self, *a, **k):
        self._device = None

    def enable_custom_device(self, device_type, device_id=0):
        self._device = device_type
        self._device_id = device_id

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self):
        return self._device != "cpu"

    def gpu_device_id(self):
        return self._device_id

    def _torch_device(self):
        """Where a predictor runs: ``cuda:<device_id>``, the CPU after
        ``disable_gpu()``, or a custom device type as given."""
        if self._device is None:
            return f"cuda:{self._device_id}"
        if self._device == "cpu":
            return "cpu"
        return f"{self._device}:{self._device_id}"

    # ---- optimization knobs (recorded for parity) -----------------------
    def switch_ir_optim(self, x=True):
        self._ir_optim = bool(x)

    def ir_optim(self):
        return self._ir_optim

    def enable_memory_optim(self, x=True):
        self._memory_optim = bool(x)

    def set_cpu_math_library_num_threads(self, n):
        self._cpu_math_threads = int(n)

    def enable_profile(self):
        self._enable_profile = True

    # ---- LLM serving engine ---------------------------------------------
    def enable_llm_engine(self, x=True, **engine_kwargs):
        """Route llama serving artifacts through ``serving.LLMEngine``.
        ``engine_kwargs`` forward to ``LLMEngine`` (``num_blocks``,
        ``block_size``, ``max_batch_size``, ...), except ``SamplingParams``'
        fields (``max_new_tokens``, ``eos_token_id``, ...), which become
        every request's sampling. Returns the config, so calls chain."""
        self._llm_engine = bool(x)
        if engine_kwargs:
            self._llm_engine_kwargs.update(engine_kwargs)
        return self

    def llm_engine_enabled(self):
        return self._llm_engine

    def summary(self):
        return (f"prog_file: {self._prog_file}\n"
                f"device: {self._torch_device()}\n"
                f"precision: {self._precision}\n"
                f"ir_optim: {self._ir_optim} (recorded)\n"
                f"llm_engine: {self._llm_engine}")


class Tensor:
    """In/out handle (reference paddle_infer::Tensor)."""

    def __init__(self, name, spec=None):
        self._name = name
        self._spec = spec
        self._value = None

    def name(self):
        return self._name

    def copy_from_cpu(self, data):
        self._value = np.asarray(data)

    def copy_to_cpu(self):
        return np.asarray(self._value)

    def share_external_data(self, data):
        self._value = data

    def shape(self):
        if self._value is not None:
            return list(np.asarray(self._value).shape)
        return list(self._spec[0]) if self._spec else None

    def reshape(self, shape):
        pass  # shapes are taken from the bound data

    def type(self):
        return self._spec[1] if self._spec else None


class Predictor:
    """The reference's handle-based session over a deserialized StableHLO
    program: not ported (``jit.save`` is not)."""

    def __init__(self, config):
        raise NotImplementedError(
            f"Predictor({config.prog_file()!r}): {_NO_JIT}; llama serving "
            "artifacts are served through Config.enable_llm_engine()")


class LLMEnginePredictor:
    """Predictor-shaped front over ``serving.LLMEngine``, what
    ``create_predictor`` returns for a llama serving artifact when
    ``Config.enable_llm_engine()`` is set.

    Bind int32 token ids ``[B, S]`` to ``input_ids`` (zero-padded rows
    with the optional ``seq_lens`` handle); ``run()`` submits every row as
    a request, drives the engine to completion and fills one output handle
    per row with that row's prompt and generated tokens. ``seq_lens``
    describes one batch: it is cleared after each run, and a count that
    does not match the rows raises ``ValueError``. The engine is
    ``.engine`` (streaming, ``reload_weights``)."""

    def __init__(self, config):
        import dataclasses

        from .serving import LLMEngine, load_llama_artifact
        from .serving.scheduler import SamplingParams

        self._config = config
        path = config.prog_file()
        if path is None:
            raise ValueError("Config has no model path; use "
                             "Config(prog_file) or set_model()")
        kwargs = dict(config._llm_engine_kwargs)
        # sampling knobs (max_new_tokens, eos_token_id, …) split off from
        # the engine-construction knobs by SamplingParams' field names
        fields = {f.name for f in dataclasses.fields(SamplingParams)}
        samp = {k: kwargs.pop(k) for k in list(kwargs) if k in fields}
        self._sampling = SamplingParams(**samp) if samp else None
        device = config._torch_device()
        self.engine = LLMEngine(load_llama_artifact(path, device=device),
                                device=device, **kwargs)
        self._inputs = {"input_ids": Tensor("input_ids", ([-1, -1], "int32")),
                        "seq_lens": Tensor("seq_lens", ([-1], "int32"))}
        # placeholder handle so every advertised output name is fetchable
        # even before the first run() (one handle per row appears after)
        self._outputs = {"out0": Tensor("out0")}

    def get_input_names(self):
        return list(self._inputs)

    def get_input_handle(self, name):
        return self._inputs[name]

    def get_output_names(self):
        return list(self._outputs)

    def get_output_handle(self, name):
        return self._outputs[name]

    def run(self, inputs=None):
        import dataclasses as _dc

        if inputs is not None:
            self._inputs["input_ids"].copy_from_cpu(np.asarray(inputs[0]))
            if len(inputs) > 1:
                self._inputs["seq_lens"].copy_from_cpu(np.asarray(inputs[1]))
        ids = np.asarray(self._inputs["input_ids"]._value)
        if ids.ndim == 1:
            ids = ids[None]
        lens_h = self._inputs["seq_lens"]._value
        if lens_h is not None:
            lens = np.asarray(lens_h).reshape(-1)
            if lens.shape[0] != ids.shape[0]:
                raise ValueError(
                    f"seq_lens has {lens.shape[0]} entries for "
                    f"{ids.shape[0]} input rows")
        else:
            lens = np.full(ids.shape[0], ids.shape[1])
        prompts = [ids[i, :int(lens[i])] for i in range(ids.shape[0])]
        outs = self.engine.generate(
            prompts, _dc.replace(self._sampling) if self._sampling else None)
        # seq_lens describes THIS batch only — clear it so the next run's
        # (possibly unpadded, differently-sized) batch is not silently
        # truncated by stale lengths
        self._inputs["seq_lens"]._value = None
        fresh = {}
        for i, o in enumerate(outs):
            t = Tensor(f"out{i}")
            t._value = np.asarray(o)
            fresh[f"out{i}"] = t
        self._outputs = fresh or {"out0": Tensor("out0")}
        return outs

    def try_shrink_memory(self):
        pass

    def close(self):
        self.engine.close()


def create_predictor(config: Config):
    """An :class:`LLMEnginePredictor` for a llama serving artifact under
    ``enable_llm_engine()``; anything else is the StableHLO
    :class:`Predictor`, which raises ``NotImplementedError``."""
    if config._llm_engine:
        path = config.prog_file()
        if path is not None and serving.is_llama_artifact(path):
            return LLMEnginePredictor(config)
    return Predictor(config)


class DataType:
    """reference paddle_infer.DataType enum."""

    FLOAT32 = 0
    INT64 = 1
    INT32 = 2
    UINT8 = 3
    INT8 = 4
    FLOAT16 = 5
    BFLOAT16 = 6
    FLOAT64 = 7
    BOOL = 8


def get_num_bytes_of_data_type(dtype):
    sizes = {DataType.FLOAT32: 4, DataType.INT64: 8, DataType.INT32: 4,
             DataType.UINT8: 1, DataType.INT8: 1, DataType.FLOAT16: 2,
             DataType.BFLOAT16: 2, DataType.FLOAT64: 8, DataType.BOOL: 1}
    return sizes[dtype]


def get_trt_compile_version():
    """No TensorRT in the port; the version triple is all-zero, as the
    reference reports."""
    return (0, 0, 0)


def get_trt_runtime_version():
    return (0, 0, 0)


def _get_phi_kernel_name(op_name):
    """PHI kernel names map through unchanged."""
    return op_name


class XpuConfig:
    """Kunlun XPU deploy knobs — accepted, inert (no XPU backend)."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)


class PredictorPool:
    """reference paddle_infer.PredictorPool: N predictors over one config,
    each further one a ``clone()`` of the first. Only the StableHLO
    ``Predictor`` has ``clone`` in the reference; the port's predictor,
    ``LLMEnginePredictor``, has none, so a pool holds one predictor and
    ``size > 1`` raises before anything is loaded."""

    def __init__(self, config, size=1):
        if size > 1:
            raise NotImplementedError(
                f"PredictorPool(size={size}): further predictors are clones "
                f"of the first, and only the StableHLO predictor clones; "
                f"{_NO_JIT}. LLMEnginePredictor has no clone: build one "
                f"engine per predictor with create_predictor")
        self._preds = [create_predictor(config)]

    def retrive(self, idx):  # reference spells it this way
        return self._preds[idx]

    retrieve = retrive


def convert_to_mixed_precision(model_file, params_file, mixed_model_file,
                               mixed_params_file, mixed_precision,
                               backend=None, keep_io_types=True,
                               black_list=None, **kwargs):
    """The reference's offline precision rewrite of a ``jit.save``
    program: not ported."""
    raise NotImplementedError(f"convert_to_mixed_precision: {_NO_JIT}")
