"""Training batches from a config's dataset and pipeline, the counterpart of
the JAX package's ``tools/train.py::dataset_iterator`` (with ``make_batch``
for the darkfarm families) and of ``data/prefetch.py``'s background
loading.

A ``DataLoader`` with ``workers`` processes (spawned) runs the host stages
of each sample: the reference-frame sampler, the annotations and the PNG
decoding (``Compose.host``); a thread pins what they hand over. The main
process moves the clip to ``device`` and runs the rest of the pipeline
there (``Compose.device_stage``: resize, brighten, flip, normalise, pad
and formatting, or the RAW and noise steps), pads the frames to the
model's static ``pad_h`` x ``pad_w`` and the key frame's gts to
``MAX_GTS``, and builds a ``DarkfarmBatch`` of one sample.

A spawned worker imports the program's main module: one that sets CUDA
state when imported (``torch.backends.cuda`` flags, for one) makes the
workers abort when they exit, so set such state under
``if __name__ == "__main__"``.

Sample order: one permutation of the dataset an epoch from
``np.random.RandomState(seed)``, as the JAX iterator permutes with numpy's
global generator. Each sample's draws come from
``random.Random(sample_seed(seed, step, 0))`` (the sampler, the flip coin,
the noise and RAW seeds, in the JAX package's order), so batches do not
depend on the number of workers, and a run resumed at step s reads the
batches of steps s, s + 1, ...
"""

from __future__ import annotations

import multiprocessing
import random
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler

from ..models.vid.selsa_darkfarm import DarkfarmBatch
from .datasets import DATASETS, CocoVideoDataset
from .pipelines import Compose, to_device

DATA_STREAM = 1  # tells the data's seeds from the loss's (seed, step, i)
MAX_GTS = 32  # the key frame's gt slots, as the JAX iterator's


def sample_seed(seed: int, step: int, i: int) -> int:
    """The seed of the ``random.Random`` of sample ``i`` of global step
    ``step``."""
    return int(np.random.SeedSequence((seed, step, i, DATA_STREAM))
               .generate_state(1, np.uint64)[0])


def build_dataset(dcfg: dict) -> CocoVideoDataset:
    """``data.train`` of a config -> its dataset (COCO-VID types)."""
    if dcfg["type"] not in DATASETS:
        raise ValueError(f"dataset type {dcfg['type']!r}: the port reads "
                         f"{sorted(DATASETS)}")
    return DATASETS[dcfg["type"]](
        ann_file=dcfg["ann_file"], img_prefix=dcfg.get("img_prefix", ""),
        ref_img_sampler=dict(dcfg.get("ref_img_sampler") or {}))


class StepOrder(Sampler):
    """(dataset index, global step) for steps ``start``, ``start + 1``,
    ...: epoch e reads the e-th permutation of
    ``np.random.RandomState(seed)``."""

    def __init__(self, n: int, seed: int, start: int = 0):
        self.n, self.seed, self.start = n, seed, start

    def __iter__(self):
        perms = np.random.RandomState(self.seed)
        epoch, order, step = -1, None, self.start
        while True:
            while epoch < step // self.n:
                order, epoch = perms.permutation(self.n), epoch + 1
            yield int(order[step % self.n]), step
            step += 1


class HostClips(Dataset):
    """The host stages of a sample: ``[(idx, step)]`` -> the clip's frame
    dicts after ``pipeline.host``, its images and annotations as CPU
    tensors in shared memory (a worker hands over their handles, not their
    bytes, through its pipe), its ``random.Random`` in the state the device
    stages continue from, and the ms it took. The tensors are moved to
    shared memory here, in the worker's own thread: left to the queue's
    feeder thread, that copy could still run when the worker exits, which
    aborts the process."""

    def __init__(self, dataset: CocoVideoDataset, pipeline: Compose,
                 seed: int):
        self.dataset, self.pipeline, self.seed = dataset, pipeline, seed

    def __getitem__(self, key):
        idx, step = key
        t = time.perf_counter()
        rng = random.Random(sample_seed(self.seed, step, 0))
        ds = self.dataset
        s = ds.get_sample(idx, rng)
        frames = [dict(img_info=s["img_info"], ann=s["ann"],
                       img_prefix=ds.img_prefix)]
        for r, a in zip(s.get("ref_img_infos", []), s.get("ref_anns", [])):
            frames.append(dict(img_info=r, ann=a, img_prefix=ds.img_prefix))
        frames = to_device(self.pipeline.host(frames, rng), "cpu")
        for f in frames:
            for v in f.values():
                if isinstance(v, torch.Tensor):
                    v.share_memory_()
        return dict(frames=frames, rng=rng, step=step,
                    host_ms=(time.perf_counter() - t) * 1e3)


def _one(batch):
    return batch


def _worker_init(worker_id):
    torch.set_num_threads(1)  # the host stages need no intra-op threads


def pad_batch(out: Dict, pad_h: int, pad_w: int
              ) -> Dict[str, torch.Tensor]:
    """A formatted clip -> the JAX iterator's dict: the key and reference
    frames [T, pad_h, pad_w, C] (zeros beyond, cut beyond), ``img_shape``
    the padded clip's (h, w) within the bucket, the key frame's gts in
    MAX_GTS slots with labels and a validity mask."""
    img = out["img"]
    imgs = torch.cat([img[None], out["ref_img"]]) if "ref_img" in out \
        else img[None]
    dev = imgs.device
    h, w = min(imgs.shape[1], pad_h), min(imgs.shape[2], pad_w)
    canvas = imgs.new_zeros((imgs.shape[0], pad_h, pad_w, imgs.shape[-1]))
    canvas[:, :h, :w] = imgs[:, :h, :w]
    boxes, labels = out["gt_bboxes"], out["gt_labels"]
    n = min(boxes.shape[0], MAX_GTS)
    g = torch.zeros((MAX_GTS, 4), dtype=torch.float32, device=dev)
    lab = torch.zeros((MAX_GTS,), dtype=torch.int64, device=dev)
    val = torch.zeros((MAX_GTS,), dtype=torch.bool, device=dev)
    g[:n], lab[:n], val[:n] = boxes[:n], labels[:n], True
    return dict(imgs=canvas,
                img_shape=torch.tensor([float(h), float(w)], device=dev),
                gt_boxes=g, gt_labels=lab, gt_valid=val)


def make_batch(d: Dict[str, torch.Tensor], in_channels: int
               ) -> DarkfarmBatch:
    """The JAX ``make_batch`` of the darkfarm families, with a leading
    batch axis of 1: 2C-channel pairs (a C-channel clip is paired with
    itself)."""
    imgs = d["imgs"]
    if imgs.shape[-1] == in_channels:
        imgs = torch.cat([imgs, imgs], -1)
    if imgs.shape[-1] != 2 * in_channels:
        raise ValueError(f"the darkfarm pipeline must give {2 * in_channels}"
                         f"-channel pairs, not {imgs.shape[-1]}")
    return DarkfarmBatch(*(t[None] for t in (
        imgs, d["img_shape"], d["gt_boxes"], d["gt_labels"], d["gt_valid"])))


class TrainLoader:
    """Iterates ``DarkfarmBatch``es of one sample for global steps
    ``start``, ``start + 1``, ... (see the module docstring). ``timings``
    gets one dict a batch: ``host_ms`` (the worker's sampling, annotations
    and decoding), ``wait_ms`` (how long the main process waited for it)
    and ``device_ms`` (the main process's device stages and batching: the
    time to launch them). ``close`` stops the workers."""

    def __init__(self, cfg: dict, pad_h: int, pad_w: int, in_channels: int,
                 seed: int = 0, start: int = 0, device="cuda",
                 workers: Optional[int] = None):
        dcfg = cfg["data"]["train"]
        self.device = torch.device(device)
        self.pipeline = Compose(dcfg["pipeline"], device=self.device)
        self.dataset = build_dataset(dcfg)
        if not len(self.dataset):
            raise ValueError(f"{dcfg['ann_file']}: no training frames")
        self.pad_h, self.pad_w, self.in_channels = pad_h, pad_w, in_channels
        if workers is None:
            workers = int(cfg["data"].get("workers_per_gpu", 2))
        self.loader = DataLoader(
            HostClips(self.dataset, self.pipeline, seed),
            sampler=StepOrder(len(self.dataset), seed, start),
            batch_size=None, collate_fn=_one, num_workers=workers,
            worker_init_fn=_worker_init if workers else None,
            multiprocessing_context=(multiprocessing.get_context("spawn")
                                     if workers else None),
            # a background thread copies each sample into pinned memory
            # (touching the shared pages there, not in the main thread)
            pin_memory=bool(workers) and self.device.type == "cuda",
            persistent_workers=False)
        self.timings: List[Dict[str, float]] = []
        self._it: Optional[Iterator] = None

    def device_batch(self, item) -> DarkfarmBatch:
        """The device stages of one host sample, padded and batched."""
        rng = item["rng"]
        out = self.pipeline.device_stage(
            to_device(item["frames"], self.device), rng)
        return make_batch(pad_batch(out, self.pad_h, self.pad_w),
                          self.in_channels)

    def __iter__(self):
        return self

    def __next__(self) -> DarkfarmBatch:
        if self._it is None:
            self._it = iter(self.loader)
        t = time.perf_counter()
        item = next(self._it)
        t1 = time.perf_counter()
        batch = self.device_batch(item)
        self.timings.append(dict(
            step=item["step"], host_ms=item["host_ms"],
            wait_ms=(t1 - t) * 1e3,
            device_ms=(time.perf_counter() - t1) * 1e3))
        return batch

    def close(self):
        """Stop the worker processes."""
        it, self._it = self._it, None
        if it is not None and hasattr(it, "_shutdown_workers"):
            it._shutdown_workers()
