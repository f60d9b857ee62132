"""highresnet_tpu_torch — the PyTorch/CUDA port of highresnet_tpu for NVIDIA Hopper.

The JAX package ``highresnet_tpu`` is the reference; this package runs the
same models on PyTorch, with the TPU's Pallas kernels rewritten by hand in
CUDA for sm_90a. It imports ``torch`` and never JAX, nor anything of
``highresnet_tpu``. Ported so far: the HRNet serving path (``cli.predict``),
the registered training path (``cli.train``), the registration toolkit
(``registration``) and the fusion lab (``labs.fusion_lab4``).

- ``models``   HRNet, ShiftNet, the VGG19 feature extractor, f32-parameter
               layers, weight IO.
- ``ops``      fusion pair pack/unpack, the bulk-copy pack and the Lanczos
               warp (CUDA kernels + plain twins), losses, cPSNR metrics.
- ``kernels``  nvcc build of ``csrc/*.cu`` and its ctypes binding.
- ``registration``  batched warps, masked metrics, shift searches, scene
               preprocessing, the headless session and its Qt app.
- ``config``, ``data``, ``utils``  the port's own copies of the JAX
               package's host code (configs, scene loading, PNG IO,
               display helpers).
- ``labs``     perf labs run as modules.
- ``train``    train state, steps, epoch loop, checkpoints, selection.
- ``eval``     scene scoring, ESA-ratio table, submission writer.
- ``runtime``  device setup (TF32 off, deterministic) and compute dtypes.
"""

__version__ = "0.1.0"

_TOP_LEVEL = {
    # name -> (module, attribute)
    "HRNet": ("highresnet_tpu_torch.models.hrnet", "HRNet"),
    "Model": ("highresnet_tpu_torch.eval.evaluator", "Model"),
    "load_data": ("highresnet_tpu_torch.eval.evaluator", "load_data"),
    "load_config": ("highresnet_tpu_torch.config", "load_config"),
}


def __getattr__(name):
    """Lazy top-level API: ``from highresnet_tpu_torch import Model, HRNet``."""
    try:
        module, attr = _TOP_LEVEL[name]
    except KeyError:
        raise AttributeError(f"module 'highresnet_tpu_torch' has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(module), attr)


def __dir__():
    return sorted(list(globals()) + list(_TOP_LEVEL))
