"""Training batches and test frames from a config's dataset and pipeline,
the counterpart of the JAX package's ``tools/train.py::dataset_iterator``
(with ``make_batch`` for the darkfarm families), of ``data/prefetch.py``'s
background loading and of the frame preparation in ``apis/test.py``.

A ``DataLoader`` with ``workers`` processes (spawned) runs the host stages
of each sample: the reference-frame sampler, the annotations and the PNG or
JPEG decoding (``Compose.host``); a thread pins what they hand over. The main
process moves the clip to ``device`` and runs the rest of the pipeline
there (``Compose.device_stage``: resize, brighten, flip, normalise, pad
and formatting, or the RAW and noise steps), pads the frames to the
model's static ``pad_h`` x ``pad_w`` and the key frame's gts to
``MAX_GTS``, and builds a ``DarkfarmBatch`` of one sample (a ``TrainBatch``
for the ImageNet-VID families, a ``DetTrainBatch`` for the image detectors
on an image dataset such as ``CocoDataset``).

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

The test loop's frames come through ``TestLoader``: the same split, its
workers decoding the frames of ``stream_plan`` (each file once a video)
in dataset order, the main process running the device stages.
"""

from __future__ import annotations

import multiprocessing
import random
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler, get_worker_info

from ..models.detectors.faster_rcnn import DetTrainBatch
from ..models.vid.selsa import TrainBatch
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


def build_dataset(dcfg: dict, test_mode: bool = False) -> CocoVideoDataset:
    """``data.train`` (or with ``test_mode`` ``data.test`` / ``data.val``)
    of a config -> its dataset (``DATASETS``: the COCO-VID types and the
    image datasets; an ``XMLDataset`` takes the config's ``classes``). A
    test dataset keeps every frame, and one without a ``ref_img_sampler``
    samples no references."""
    if dcfg["type"] not in DATASETS:
        raise ValueError(f"dataset type {dcfg['type']!r}: the port reads "
                         f"{sorted(DATASETS)}")
    sampler = dict(dcfg.get("ref_img_sampler") or {})
    extra = ({"classes": dcfg["classes"]} if dcfg["type"] == "XMLDataset"
             and "classes" in dcfg else {})
    return DATASETS[dcfg["type"]](
        ann_file=dcfg["ann_file"], img_prefix=dcfg.get("img_prefix", ""),
        ref_img_sampler=(sampler or None) if test_mode else sampler,
        test_mode=test_mode, **extra)


def loader_workers(cfg: dict) -> int:
    """The config's loader processes, ``data.workers_per_gpu`` (2 when
    unset)."""
    return int(cfg["data"].get("workers_per_gpu", 2))


class StepOrder(Sampler):
    """(dataset index, global step) for steps ``start``, ``start + 1``,
    ...: epoch e reads the e-th permutation of
    ``np.random.RandomState(seed)``. Setting ``stopped`` ends the
    iteration."""

    def __init__(self, n: int, seed: int, start: int = 0):
        self.n, self.seed, self.start = n, seed, start
        self.stopped = False

    def __iter__(self):
        perms = np.random.RandomState(self.seed)
        epoch, order, step = -1, None, self.start
        while not self.stopped:
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


def make_image_batch(d: Dict[str, torch.Tensor]) -> DetTrainBatch:
    """The JAX ``make_batch`` of the image families, with a leading batch
    axis of 1: the image's first 3 channels [1, H, W, 3]."""
    return DetTrainBatch(*(t[None] for t in (
        d["imgs"][0, ..., :3], d["img_shape"], d["gt_boxes"],
        d["gt_labels"], d["gt_valid"])))


def make_frame_batch(d: Dict[str, torch.Tensor]) -> TrainBatch:
    """The JAX ``make_batch`` of the ImageNet-VID families (SELSA, FGFA,
    DFF), with a leading batch axis of 1: the frames' first 3 channels (the
    noisy half of a pair)."""
    return TrainBatch(*(t[None] for t in (
        d["imgs"][..., :3], d["img_shape"], d["gt_boxes"], d["gt_labels"],
        d["gt_valid"])))


class TrainLoader:
    """Iterates ``DarkfarmBatch``es (with ``pairs=False`` ``TrainBatch``es,
    ``make_frame_batch``; from an image dataset ``DetTrainBatch``es,
    ``make_image_batch``) of one sample for global steps
    ``start``, ``start + 1``, ... (see the module docstring). ``timings``
    gets one dict a batch: ``host_ms`` (the worker's sampling, annotations
    and decoding), ``wait_ms`` (how long the main process waited for it)
    and ``device_ms`` (the main process's device stages and batching: the
    time to launch them). ``close`` stops the workers."""

    def __init__(self, cfg: dict, pad_h: int, pad_w: int, in_channels: int,
                 seed: int = 0, start: int = 0, device="cuda",
                 workers: Optional[int] = None, pairs: bool = True):
        dcfg = cfg["data"]["train"]
        self.device = torch.device(device)
        self.pipeline = Compose(dcfg["pipeline"], device=self.device)
        self.dataset = build_dataset(dcfg)
        if not len(self.dataset):
            raise ValueError(f"{dcfg['ann_file']}: no training frames")
        self.pad_h, self.pad_w, self.in_channels = pad_h, pad_w, in_channels
        self.pairs = pairs
        if workers is None:
            workers = loader_workers(cfg)
        self.order = StepOrder(len(self.dataset), seed, start)
        self.loader = DataLoader(
            HostClips(self.dataset, self.pipeline, seed),
            sampler=self.order,
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

    def device_batch(self, item):
        """The device stages of one host sample, padded and batched."""
        rng = item["rng"]
        out = self.pipeline.device_stage(
            to_device(item["frames"], self.device), rng)
        if not getattr(self.dataset, "is_video", True):
            padded = pad_batch(out[0] if isinstance(out, list) else out,
                               self.pad_h, self.pad_w)
            return make_image_batch(padded)
        padded = pad_batch(out, self.pad_h, self.pad_w)
        if not self.pairs:
            return make_frame_batch(padded)
        return make_batch(padded, self.in_channels)

    def __iter__(self):
        return self

    def __next__(self):
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
        """Stop the worker processes: the sampler ends, the samples they
        are preparing are received and dropped, and they exit idle (a
        worker told to exit while its queue still hands a sample over can
        abort at exit)."""
        it, self._it = self._it, None
        if it is not None and hasattr(it, "_shutdown_workers"):
            self.order.stopped = True
            for _ in it:  # ends by shutting the workers down
                pass


def _file_key(info: dict):
    return info.get("filename", info.get("file_name"))


def stream_plan(dataset: CocoVideoDataset,
                indices: Optional[Sequence[int]] = None):
    """What the test loop prepares for each frame, in order: the JAX
    ``single_device_test``'s per-video reference cache
    (``apis/test.py:52-81``) as a plan. A frame's file is prepared once a
    video: the references of frame 0 (``test_with_adaptive_stride`` spans
    the video) are kept by file name until they come up as key frames, and
    the cache empties at each frame 0. Returns ``jobs``, the frames to run the pipeline's host stages
    on, as (slot, frame dict), and ``steps``, one a frame: its dataset
    ``index`` and ``sample``, how many jobs it takes (``n_jobs``), its
    ``key`` slot, its ``refs`` slots (frame 0 with references, else None)
    and whether the prepared frames are dropped first (``reset``). A slot
    is a file name; the key frame's is dropped after its frame, as no
    later frame takes it from the cache."""
    indices = list(indices) if indices is not None else range(len(dataset))
    jobs, steps, cached = [], [], set()
    prefix = dataset.img_prefix

    def job(slot, info, ann=None):
        frame = dict(img_info=dict(info), img_prefix=prefix)
        if ann is not None:
            frame["ann"] = ann
        jobs.append((slot, frame))

    for i in indices:
        s = dataset[i]
        info = s["img_info"]
        fid = info.get("frame_id", 0)
        if fid == 0:
            cached = set()
        n0, key = len(jobs), _file_key(info)
        if key in cached:
            cached.remove(key)
        else:
            job(key, info, s.get("ann"))
        refs = None
        if fid == 0 and s.get("ref_img_infos"):
            cached.add(key)
            refs = [_file_key(r) for r in s["ref_img_infos"]]
            for k, r in zip(refs, s["ref_img_infos"]):
                if k not in cached:
                    job(k, r)
                    cached.add(k)
            cached.discard(key)
        steps.append(dict(index=i, sample=s, n_jobs=len(jobs) - n0, key=key,
                          refs=refs, reset=fid == 0))
    return jobs, steps


class HostFrames(Dataset):
    """The host stages (decoding) of the test loop's jobs: job k -> its
    slot, its frame dict after ``pipeline.host`` with the images as CPU
    tensors (in shared memory when a worker made them, moved there in the
    worker's own thread as ``HostClips`` does) and the ms it took."""

    def __init__(self, jobs, pipeline: Compose):
        self.jobs, self.pipeline = jobs, pipeline

    def __len__(self):
        return len(self.jobs)

    def __getitem__(self, k):
        t = time.perf_counter()
        slot, frame = self.jobs[k]
        frame = to_device(self.pipeline.host(dict(frame), None), "cpu")
        if get_worker_info() is not None:
            for v in frame.values():
                if isinstance(v, torch.Tensor):
                    v.share_memory_()
        return dict(slot=slot, frame=frame,
                    host_ms=(time.perf_counter() - t) * 1e3)


class TestLoader:
    """The test frames of ``dataset`` at ``indices`` (all by default) in
    order, each prepared by the test ``pipeline`` as ``stream_plan`` says:
    ``workers`` spawned processes (none: the main process) run the host
    stages of the plan's jobs in order and hand the frames over in shared
    memory; the main process moves them to the pipeline's device and runs
    its device stages there. ``frames()`` yields, a frame, its dataset
    ``index``, its ``sample``, the prepared key frame (``prepared``, the
    pipeline's output) and at frame 0 the prepared reference images
    (``ref_imgs``, else None). ``timings`` gets one dict a frame:
    ``host_ms`` (the decoding of its jobs, in a worker), ``wait_ms`` (how
    long the main process waited for them) and ``device_ms`` (the device
    stages' launch time). The results do not depend on ``workers``."""

    def __init__(self, dataset: CocoVideoDataset, pipeline: Compose,
                 indices: Optional[Sequence[int]] = None, workers: int = 0):
        self.pipeline, self.workers = pipeline, workers
        self.jobs, self.steps = stream_plan(dataset, indices)
        self.timings: List[Dict[str, float]] = []

    def _loader(self):
        w = self.workers
        return DataLoader(
            HostFrames(self.jobs, self.pipeline), batch_size=None,
            shuffle=False, collate_fn=_one, num_workers=w,
            worker_init_fn=_worker_init if w else None,
            multiprocessing_context=(multiprocessing.get_context("spawn")
                                     if w else None),
            pin_memory=bool(w) and self.pipeline.device.type == "cuda",
            persistent_workers=False)

    def frames(self) -> Iterator[dict]:
        it = iter(self._loader())
        store: Dict[object, dict] = {}
        try:
            for step in self.steps:
                if step["reset"]:
                    store.clear()
                host = wait = dev = 0.0
                for _ in range(step["n_jobs"]):
                    t = time.perf_counter()
                    item = next(it)
                    t1 = time.perf_counter()
                    store[item["slot"]] = self.pipeline.device_stage(
                        to_device(item["frame"], self.pipeline.device), None)
                    host += item["host_ms"]
                    wait += (t1 - t) * 1e3
                    dev += (time.perf_counter() - t1) * 1e3
                self.timings.append(dict(index=step["index"], host_ms=host,
                                         wait_ms=wait, device_ms=dev))
                refs = step["refs"]
                yield dict(index=step["index"], sample=step["sample"],
                           prepared=store[step["key"]],
                           ref_imgs=None if refs is None else
                           [store[k]["img"] for k in refs])
                del store[step["key"]]
        finally:
            if hasattr(it, "_shutdown_workers"):
                it._shutdown_workers()
