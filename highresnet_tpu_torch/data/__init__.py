"""Scene loading: the port's own copies of the JAX package's host-side data code.

``probav``, ``pack``, ``collate``, ``augment``, ``pipeline`` and ``synth``
are copies of ``highresnet_tpu/data/*`` with their imports pointed at this
package, so the port imports nothing of ``highresnet_tpu``. They import
numpy, PIL and OpenCV (scipy for ``synth``). Without scikit-learn,
``train_val_split`` takes its seeded local shuffle, which assigns every
scene as sklearn's does at the drivers' scene counts
(``tests/test_torch_examples.py``). ``make_synthetic_dataset`` writes a
Proba-V-layout tree of seeded scenes.
"""

from highresnet_tpu_torch.data.collate import Batch, collate
from highresnet_tpu_torch.data.pipeline import BatchLoader
from highresnet_tpu_torch.data.probav import (
    ImageSet,
    SceneDataset,
    discover_scenes,
    read_baseline_cpsnr,
    read_imageset,
    train_val_split,
)
from highresnet_tpu_torch.data.synth import make_synthetic_dataset

__all__ = [
    "Batch",
    "BatchLoader",
    "ImageSet",
    "SceneDataset",
    "collate",
    "discover_scenes",
    "make_synthetic_dataset",
    "read_baseline_cpsnr",
    "read_imageset",
    "train_val_split",
]
