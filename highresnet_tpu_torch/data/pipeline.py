"""Host-side input pipeline: sharded scene reading + threaded prefetch.

The port's own copy of ``highresnet_tpu/data/pipeline.py``, imports pointed at
``highresnet_tpu_torch``; the port imports nothing of the JAX package.

The reference feeds the GPU through torch DataLoader worker processes
(src/train.py:274-287). The TPU-native equivalent:

- each host takes a deterministic shard of the scene list
  (``shard_for_hosts``) — the multi-host analog of the single train list;
- a thread pool reads + decodes PNG scenes ahead of the consumer
  (PNG decode releases the GIL in cv2/PIL, so threads scale);
- batches come out as NumPy, ready for ``jax.device_put`` with a
  ``NamedSharding`` over the data axis (see parallel/mesh.py).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Sequence

import numpy as np

from highresnet_tpu_torch.data.collate import Batch, collate
from highresnet_tpu_torch.data.probav import read_imageset


def shard_for_hosts(scene_dirs: Sequence[str], host_id: int, n_hosts: int) -> List[str]:
    """Deterministic per-host shard of the scene list, EQUAL length per host.

    The list is truncated to a multiple of n_hosts before round-robin
    assignment so every host sees the same number of scenes — a
    requirement for collective-running train steps (unequal shards would
    desynchronize per-host step counts and deadlock the collectives).
    """
    n = (len(scene_dirs) // n_hosts) * n_hosts
    return [d for i, d in enumerate(scene_dirs[:n]) if i % n_hosts == host_id]


class BatchLoader:
    """Iterable over collated batches with background prefetch.

    Each epoch reshuffles scene order (seeded, epoch-keyed) and re-samples
    views/patches per scene — matching the reference DataLoader's
    shuffle=True + per-__getitem__ random sampling.
    """

    def __init__(
        self,
        scene_dirs: Sequence[str],
        batch_size: int,
        min_l: int,
        top_k: int = -1,
        beta: float = 0.0,
        create_patches: bool = False,
        patch_size: int = 64,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 4,
        augment: bool = False,
        variable_views_p: float = 0.0,
    ):
        self.scene_dirs = list(scene_dirs)
        self.batch_size = batch_size
        self.min_l = min_l
        self.top_k = top_k
        self.beta = beta
        self.create_patches = create_patches
        self.patch_size = patch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.augment = augment
        self.variable_views_p = variable_views_p
        self.epoch = 0

    def __len__(self):
        n = len(self.scene_dirs)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def num_scenes(self):
        return len(self.scene_dirs)

    def _epoch_order(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(len(self.scene_dirs))
        rng = np.random.default_rng((self.seed, self.epoch))
        return rng.permutation(len(self.scene_dirs))

    def _load_scene(self, idx: int, scene_rng: np.random.Generator):
        s = read_imageset(
            self.scene_dirs[idx],
            create_patches=self.create_patches,
            patch_size=self.patch_size,
            top_k=self.top_k,
            beta=self.beta,
            rng=scene_rng,
        )
        if self.augment:
            # per-scene, per-epoch random D4 element; drawn from the same
            # epoch-keyed rng as view/patch sampling so epochs stay
            # reproducible. (With EpochCache, each cached variant freezes
            # its own augmentation draw — raise n_variants for diversity.)
            from highresnet_tpu_torch.data.augment import random_dihedral_imageset

            s = random_dihedral_imageset(s, scene_rng)
        if self.variable_views_p > 0 and s.lr.shape[0] > 1:
            # variable-L training: with probability p truncate this scene to
            # a random k in [1, L-1] views (collate zero-pads back to min_L
            # with alpha=0 — the reference's any-L padding contract,
            # src/utils.py:89-95). The model then sees every view count each
            # epoch instead of specializing to exactly n_views, which is
            # what produced the off-distribution clip-floor artifact
            # (VIEWS_ABLATION.json). Same epoch-keyed rng as view/patch
            # sampling: epochs stay reproducible.
            if scene_rng.random() < self.variable_views_p:
                import dataclasses

                k = int(scene_rng.integers(1, s.lr.shape[0]))
                s = dataclasses.replace(
                    s, lr=s.lr[:k], clearances=s.clearances[:k]
                )
        return s

    def __iter__(self) -> Iterator[Batch]:
        order = self._epoch_order()
        n = len(order)
        starts = list(range(0, n, self.batch_size))
        if self.drop_last:
            starts = [s for s in starts if s + self.batch_size <= n]

        out_q: "queue.Queue[tuple[int, Batch | Exception]]" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """Bounded put that wakes up if the consumer abandons the
            iterator (otherwise the producer thread would block forever
            on the full queue and leak itself + its batches)."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            import concurrent.futures as cf

            with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                for bi, s in enumerate(starts):
                    if stop.is_set():
                        return
                    idxs = order[s : s + self.batch_size]
                    rngs = [
                        np.random.default_rng((self.seed, self.epoch, int(i)))
                        for i in idxs
                    ]
                    try:
                        sets = list(pool.map(self._load_scene, idxs, rngs))
                        if not put_or_stop((bi, collate(sets, self.min_l))):
                            return
                    except Exception as e:  # surface in consumer
                        put_or_stop((bi, e))
                        return
            put_or_stop((-1, None))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                bi, item = out_q.get()
                if bi == -1:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
        self.epoch += 1


class EpochCache:
    """Pre-collated, memory-mapped epoch cache over a BatchLoader.

    The per-epoch cost of the live pipeline is PNG/pack decode + view
    sampling + patch crop + collate for every scene — ~3 ms/scene on this
    1-core host, which leaves almost no headroom over the bf16 train step's
    consumption rate (BASELINE.md: 338 scenes/s packed vs 341 scenes/s bf16
    inference) and would starve a multi-chip consumer outright.

    This cache materializes ``n_variants`` full epoch realizations (each
    with its own view/patch sampling, epoch-keyed like the live loader) as
    one .npy per array on disk, then serves every later epoch from
    ``np.load(mmap_mode="r")`` slices: zero decode, zero collate, reads ride
    the OS page cache. Sampling diversity is bounded by n_variants — the
    classic pre-packed-epochs tradeoff; raise n_variants to taste (disk is
    batches * n_variants * ~(B*L*h*w + B*9*h*w) f32).

    Scales per-host on pods: each host caches only its own shard (the inner
    loader is already sharded by shard_for_hosts).
    """

    def __init__(self, loader: BatchLoader, cache_dir: str, n_variants: int = 2):
        import os

        if n_variants < 1:
            raise ValueError("n_variants must be >= 1")
        self.loader = loader
        self.cache_dir = cache_dir
        self.n_variants = n_variants
        self.epoch = 0
        os.makedirs(cache_dir, exist_ok=True)

    def __len__(self):
        return len(self.loader)

    @property
    def num_scenes(self):
        return self.loader.num_scenes

    def _base(self, variant: int) -> str:
        import os

        return os.path.join(self.cache_dir, f"variant{variant:03d}")

    def _is_built(self, variant: int) -> bool:
        import os

        return os.path.exists(self._base(variant) + ".meta.json")

    def _build(self, variant: int):
        """Materialize one epoch realization through the live loader.

        Yields the batches while writing them, so the building epoch costs
        no extra wall-clock over a live epoch.
        """
        import json
        import os

        batches = []
        for b in self.loader:  # advances loader.epoch => fresh sampling
            batches.append(b)
            yield b
        if not batches:
            raise ValueError("inner loader produced no batches; nothing to cache")
        base = self._base(variant)
        arrays = {}
        for field in ("lrs", "alphas", "hrs", "hr_maps"):
            vals = [getattr(b, field) for b in batches]
            if vals[0] is not None:
                arrays[field] = np.stack(vals)
        # the view ranks of one replica build the same variant at once:
        # each writes under its own names and renames, so no process reads
        # or commits a file another is still writing
        tmp = f".{os.getpid()}.tmp"
        for field, arr in arrays.items():
            np.save(base + f".{field}{tmp}.npy", arr)
            os.replace(base + f".{field}{tmp}.npy", base + f".{field}.npy")
        meta = {"names": [list(b.names) for b in batches], "fields": sorted(arrays)}
        with open(base + ".meta.json" + tmp, "w") as f:
            json.dump(meta, f)
        os.replace(base + ".meta.json" + tmp, base + ".meta.json")  # commit marker

    def _serve(self, variant: int):
        import json

        base = self._base(variant)
        with open(base + ".meta.json") as f:
            meta = json.load(f)
        mm = {
            field: np.load(base + f".{field}.npy", mmap_mode="r")
            for field in meta["fields"]
        }
        for i, names in enumerate(meta["names"]):
            get = lambda f: mm[f][i] if f in mm else None  # noqa: B023
            yield Batch(
                lrs=get("lrs"), alphas=get("alphas"), hrs=get("hrs"),
                hr_maps=get("hr_maps"), names=tuple(names),
            )

    def __iter__(self) -> Iterator[Batch]:
        variant = self.epoch % self.n_variants
        if self._is_built(variant):
            yield from self._serve(variant)
        else:
            yield from self._build(variant)
        self.epoch += 1
