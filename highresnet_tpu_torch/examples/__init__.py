"""The quality-experiment drivers: the counterparts of ``examples/*.py``.

Each ``<name>.py`` takes the JAX driver's flags and defaults, runs its arms
and protocol through the port and writes its report schema; run one as
``python -m highresnet_tpu_torch.examples.<name> [--device cpu]``. Every
driver runs on the card unless given ``--device cpu`` and calls
``runtime.setup_device`` before it builds a model (TF32 off). Reports go to
``build/examples/<NAME>.json`` by default, never onto a checked-in report.
Dataset directories default to the system's temporary directory.
"""
