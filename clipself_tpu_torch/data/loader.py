"""Training and evaluation batches for the port (a port of
`clipself_tpu/data/loader.py`).

Three routes feed the trainer, the evaluator and the tools:
  - `make_loader`: a `torch.utils.data.DataLoader` over a dataset of
    `data/datasets.py`, its items built by worker processes in NumPy, the
    batches (dicts of CPU tensors) pinned when the target is a CUDA card;
  - `NativeDistillLoader`: the C++ core (`native/loader.cc`) decoding,
    resizing and normalizing a grid-distill batch with a thread pool into
    NumPy buffers, double-buffered;
  - `SyntheticDistillData`: one seeded batch, repeated (`--synthetic`).
`device_prefetch` moves batches onto the card ahead of the step that takes
them. The trainer sees each route as a `TrainRoute` (`synthetic_route`,
`loader_route`, `native_route`): a generator of device batches an epoch.
"""

from __future__ import annotations

import collections
import itertools
import logging
import multiprocessing
from typing import Callable, Iterable, Iterator, Optional, Union

import numpy as np
import torch
from torch.utils.data import DataLoader, Sampler

from clipself_tpu_torch.core.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from clipself_tpu_torch.data import native_loader

log = logging.getLogger("clipself_tpu_torch")


class EpochPermutation(Sampler):
    """The indices of one pass: ``default_rng((seed, epoch)).permutation(n)``
    when shuffling, else 0..n-1 (the order `NativeDistillLoader` uses)."""

    def __init__(self, n: int, *, shuffle: bool, seed: int, epoch: int):
        self.n, self.shuffle, self.seed, self.epoch = n, shuffle, seed, epoch

    def __iter__(self):
        if not self.shuffle:
            return iter(range(self.n))
        return iter(np.random.default_rng((self.seed, self.epoch)).permutation(self.n).tolist())

    def __len__(self):
        return self.n


Rows = Union[slice, Callable[[int], slice]]


def rows_of(rows: Rows, size: int) -> slice:
    """The rows of a global batch of ``size`` that ``rows`` names: a slice,
    or a function of the batch's size that gives one
    (`parallel/mesh.py::batch_rows` of a mesh)."""
    return rows(size) if callable(rows) else rows


class GlobalBatches(Sampler):
    """The index lists of one pass of ``order`` in global batches of
    ``batch_size`` (consecutive runs of the order; the last partial one
    dropped with ``drop_last``), each cut to the ``rows`` that this rank of
    a mesh reads: the other ranks' rows are never read."""

    def __init__(self, order: Sampler, batch_size: int, *, drop_last: bool, rows: Rows = slice(None)):
        self.order, self.batch_size, self.drop_last, self.rows = order, batch_size, drop_last, rows

    def batches(self) -> list[tuple[list[int], bool]]:
        """(this rank's indices, whether they are fewer than the global
        batch's) of each batch of the pass."""
        order = list(self.order)
        out = []
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                break
            mine = idx[rows_of(self.rows, len(idx))]
            out.append((mine, len(mine) < len(idx)))
        return out

    def __iter__(self):
        return iter([idx for idx, _ in self.batches()])

    def __len__(self):
        n = len(self.order)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)


class RankRows(dict):
    """A batch that holds this rank's rows of a global batch, not all of
    them (`rank_batches`)."""


def rank_batches(loader: DataLoader) -> Iterator[dict]:
    """The batches of a `make_loader` loader, each one cut to this rank's
    rows marked as `RankRows`, the others (a batch that does not divide over
    the ranks, which every rank reads whole) as they are."""
    for batch, (_, cut) in zip(loader, loader.batch_sampler.batches()):
        yield RankRows(batch) if cut else batch


def make_loader(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    num_workers: int = 0,
    drop_last: bool = True,
    pin_memory: bool = False,
    rows: Rows = slice(None),
) -> DataLoader:
    """One pass over ``dataset`` in batches of ``batch_size``: dicts of CPU
    tensors stacked from the items. Training drops the last partial batch;
    evaluation passes ``drop_last=False`` so that every image is scored.

    The order is ``default_rng((seed, epoch)).permutation(len(dataset))``.
    The JAX package's grain sampler has an order of its own that cannot be
    reproduced without grain; the items agree all the same, since an item
    depends only on (seed, epoch, index). Build a loader per epoch, after
    ``dataset.set_epoch(epoch)``: worker processes copy the dataset when the
    loader starts. ``pin_memory`` is for a CUDA target only.

    ``rows`` (`rows_of`) are the rows of each global batch that this rank
    of a mesh reads: its loader builds those items alone, in the order the
    whole batch would hold them (`GlobalBatches`).

    Workers are forked from a fork server (`_worker_context`), never from
    the caller: the trainer's process runs CUDA and threads, which a fork
    does not carry safely. The workers use no CUDA. As with `spawn`, a
    script that builds a loader with workers needs the
    ``if __name__ == "__main__"`` guard."""
    order = EpochPermutation(len(dataset), shuffle=shuffle, seed=seed, epoch=epoch)
    return DataLoader(
        dataset, batch_sampler=GlobalBatches(order, batch_size, drop_last=drop_last, rows=rows),
        num_workers=num_workers, pin_memory=pin_memory,
        multiprocessing_context=_worker_context() if num_workers else None,
    )


def _worker_context():
    """The `forkserver` context with torch and the datasets preloaded in
    the server: the server starts once a process, single-threaded and
    without CUDA, and each worker forks from it with those modules already
    imported (a `spawn` worker imports torch anew, seconds a worker)."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "clipself_tpu_torch.data.datasets"])
    return ctx


def stop_worker_server() -> None:
    """Stop the fork server of `_worker_context` and the resource tracker it
    started, and wait until both have exited. Left alone they end only some
    time after this process has, so a program that must leave no process
    behind calls this last, once its loaders' workers have exited. A later
    `make_loader` starts them anew. These are CPython's own stop functions
    (its tests call them); each does nothing when its process is not running."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def _pinned(value) -> torch.Tensor:
    t = torch.as_tensor(value)
    return t if t.is_pinned() else t.pin_memory()


PREFETCH = 2  # batches in flight to the card: the one the step reads and the next


def device_prefetch(batches: Iterable[dict], device: Union[str, torch.device]) -> Iterator[dict]:
    """Yield each batch with its arrays on ``device``, `PREFETCH` batches
    ahead (`clipself_tpu/data/loader.py::device_prefetch`). On a CUDA card
    the host batches are pinned (kept as they are when the loader pinned
    them) and copied with ``non_blocking`` on a side stream, so the copy of
    the next batch overlaps the step on this one; the compute stream waits
    on the copy's event, and every tensor is ``record_stream``-ed onto it so
    its memory is not reused while the step reads it. On a CPU device a
    plain conversion to tensors."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            yield {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        return
    stream = torch.cuda.Stream(device)
    queue = collections.deque()

    def put(batch):
        host = {k: _pinned(v) for k, v in batch.items()}
        with torch.cuda.stream(stream):
            dev = {k: v.to(device, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return host, dev, done

    it = iter(batches)
    for batch in it:
        queue.append(put(batch))
        if len(queue) == PREFETCH:
            break
    while queue:
        _host, dev, done = queue.popleft()  # the pinned source lives until its copy is waited on
        compute = torch.cuda.current_stream(device)
        compute.wait_event(done)
        for t in dev.values():
            t.record_stream(compute)
        nxt = next(it, None)
        if nxt is not None:
            queue.append(put(nxt))
        yield dev


class NativeDistillLoader:
    """Batch iterator over a grid-distill dataset through the C++ core.

    Items whose `plan_item` is available (grid mode without pre-transforms)
    are decoded, resized and normalized by the native thread pool straight
    into the batch buffers; any other row, a decode failure included, is
    built by the dataset's NumPy ``__getitem__``. ``fallback_rows`` counts
    those rows, and the trainer logs it. Yields dicts of NumPy arrays,
    endlessly, advancing the dataset's epoch after each pass. ``rows``: the
    rows of each global batch of ``batch_size`` that this rank of a mesh
    reads; only their items are planned, decoded or built.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        num_threads: Optional[int] = None,
        crop_size: Optional[int] = None,
        rows: slice = slice(None),
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.rows = rows
        self.shuffle = shuffle
        self.seed = seed
        self.pool = native_loader.NativePool(num_threads)  # raises without the core
        self._num_threads = num_threads
        self._aux_pool = None  # second double-buffer half, created lazily
        self.mean = np.asarray(OPENAI_DATASET_MEAN, np.float32)
        self.std = np.asarray(OPENAI_DATASET_STD, np.float32)
        self.crop_size = crop_size or dataset.crop_size
        self.fallback_rows = 0

    def _indices(self):
        if len(self.ds) < self.batch_size:
            raise ValueError(
                f"dataset ({len(self.ds)} items) smaller than batch size "
                f"{self.batch_size}: no full batch can ever be yielded"
            )
        # the dataset's epoch is authoritative (the trainer advances it with
        # set_epoch on resume and at each epoch, reference data.py:608-618);
        # the loader only self-advances when nobody else moved it during the
        # pass. The one-batch prefetch skew: the first batch after a boundary
        # may have been planned under the previous epoch's rng.
        local_epoch = int(getattr(self.ds, "epoch", 0))
        while True:
            epoch = int(getattr(self.ds, "epoch", local_epoch))
            order = (
                np.random.default_rng((self.seed, epoch)).permutation(len(self.ds))
                if self.shuffle
                else np.arange(len(self.ds))
            )
            b = self.batch_size
            for start in range(0, len(order) - b + 1, b):
                yield order[start : start + b][self.rows]
            if int(getattr(self.ds, "epoch", epoch)) == epoch and hasattr(self.ds, "set_epoch"):
                self.ds.set_epoch(epoch + 1)
            local_epoch = epoch + 1

    def _submit(self, pool, idxs):
        b = len(idxs)
        s = self.ds.det_size
        m = self.ds.max_anns
        cs = self.crop_size
        buf = {
            "images": np.zeros((b, s, s, 3), np.float32),
            "crops": np.zeros((b, m, cs, cs, 3), np.float32),
            "boxes": np.zeros((b, m, 5), np.float32),
        }
        slow = []
        submitted = []  # batch row per submitted job, in submission order
        for j, idx in enumerate(idxs):
            plan = self.ds.plan_item(int(idx))
            if plan is None:
                slow.append(j)
                continue
            buf["boxes"][j] = plan["boxes"]
            pool.submit_distill_item(
                plan["path"], buf["images"][j], buf["crops"][j],
                plan["crop_windows"], self.mean, self.std,
            )
            submitted.append(j)
        return buf, slow, submitted, idxs

    def _finish(self, pool, buf, slow, submitted, idxs):
        status = pool.wait_status(len(submitted))
        # per-job flags confine the NumPy route to the rows that failed
        failed = [j for j, ok in zip(submitted, status) if not ok]
        if failed:
            self.fallback_rows += len(failed)
            log.warning(
                f"native loader: {len(failed)} row(s) of this batch failed in the core and "
                f"were built by the NumPy route ({self.fallback_rows} so far)"
            )
        for j in list(slow) + failed:
            item = self.ds[int(idxs[j])]
            buf["images"][j] = item["images"]
            buf["crops"][j] = item["crops"]
            buf["boxes"][j] = item["boxes"]
        return buf

    def __iter__(self):
        """Double-buffered: while the trainer consumes batch k, the pool is
        already decoding batch k+1."""
        if self._aux_pool is None:
            # same thread budget as the primary half, reused across iterators
            self._aux_pool = native_loader.NativePool(self._num_threads)
        pools = [self.pool, self._aux_pool]
        it = self._indices()
        pending = self._submit(pools[0], next(it))
        slot = 0
        while True:
            nxt_slot = 1 - slot
            nxt = self._submit(pools[nxt_slot], next(it))
            yield self._finish(pools[slot], *pending)
            pending, slot = nxt, nxt_slot

    def close(self):
        for pool in (self.pool, self._aux_pool):
            if pool is not None:
                pool.close()


class TrainRoute:
    """A training route as the trainer sees it, whichever feeds it.

    ``epoch(e)`` sets the dataset's epoch and returns a generator of batches
    on the device for that epoch; the trainer closes it when the epoch ends.
    ``steps`` is the number of batches one pass holds (None: no dataset),
    ``endless`` whether the route can run past it, ``fallback_rows`` the
    rows the native core left to the NumPy route (None on the other
    routes), and ``close()`` ends the route."""

    def __init__(self, epoch_batches, *, steps=None, endless=False, native=None, close=None):
        self._epoch_batches = epoch_batches
        self.steps = steps
        self.endless = endless
        self._native = native
        self._close = close

    @property
    def fallback_rows(self) -> Optional[int]:
        return None if self._native is None else self._native.fallback_rows

    def epoch(self, epoch: int) -> Iterator[dict]:
        return self._epoch_batches(epoch)

    def close(self) -> None:
        if self._close is not None:
            self._close()


def _forward(stream: Iterator[dict]) -> Iterator[dict]:
    """An epoch's view of an endless stream: closing it leaves the stream
    open for the next epoch."""
    while True:
        yield next(stream)


def synthetic_route(data: "SyntheticDistillData", device, *, rows: slice = slice(None)) -> TrainRoute:
    """`--synthetic`: the one batch (its ``rows``) staged on the device
    once, repeated."""
    batch = {k: torch.as_tensor(v[rows], device=device) for k, v in data.batch.items()}
    return TrainRoute(lambda epoch: _forward(itertools.repeat(batch)), endless=True)


def loader_route(
    dataset, batch_size: int, *, seed: int, workers: int, device, rows: slice = slice(None),
) -> TrainRoute:
    """`make_loader` with ``workers`` processes, built afresh each epoch
    after ``set_epoch`` (the worker processes copy the dataset, and its
    epoch, when they start), through `device_prefetch`; closing an epoch's
    generator ends its workers. One pass an epoch: ``steps`` =
    len(dataset) // batch_size. The order and the items depend on (seed,
    epoch, index) alone, so every rank of a mesh takes the seeded global
    order and reads only the items of its ``rows`` of each global batch."""
    device = torch.device(device)

    def batches(epoch):
        dataset.set_epoch(epoch)
        return device_prefetch(make_loader(
            dataset, batch_size, shuffle=True, seed=seed, epoch=epoch,
            num_workers=workers, pin_memory=device.type == "cuda", rows=rows,
        ), device)

    return TrainRoute(batches, steps=len(dataset) // batch_size)


def native_route(
    dataset, batch_size: int, *, seed: int, workers: int, device, rows: slice = slice(None),
) -> TrainRoute:
    """`NativeDistillLoader` (`--native-loader`) with ``workers`` threads:
    one endless, double-buffered stream over the epochs of this rank's
    ``rows`` of each global batch, through `device_prefetch`;
    ``fallback_rows`` counts its rows built by the NumPy route."""
    native = NativeDistillLoader(
        dataset, batch_size, shuffle=True, seed=seed, num_threads=workers, rows=rows,
    )
    stream = device_prefetch(native, device)

    def batches(epoch):
        dataset.set_epoch(epoch)
        return _forward(stream)

    def close():
        stream.close()
        native.close()

    return TrainRoute(
        batches, steps=len(dataset) // batch_size, endless=True, native=native, close=close,
    )


class SyntheticDistillData:
    """Deterministic synthetic batches shaped like GridDistillDataset items,
    the same `default_rng(seed)` draws as `clipself_tpu/data/loader.py:205-222`:
    images [B, S, S, 3], boxes [B, M, 5] (xyxy in [0, 1], valid = 1), crops
    [B, M, s, s, 3], float32 NumPy. Iterating repeats the one batch."""

    def __init__(self, batch_size=2, det_size=1024, crop_size=224, max_anns=20, seed=0):
        rng = np.random.default_rng(seed)
        b, m = batch_size, max_anns
        lo = rng.uniform(0, 0.5, (b, m, 2)).astype(np.float32)
        hi = np.clip(lo + rng.uniform(0.05, 0.5, (b, m, 2)), 0, 1).astype(np.float32)
        self.batch = {
            "images": rng.normal(size=(b, det_size, det_size, 3)).astype(np.float32),
            "boxes": np.concatenate([lo, hi, np.ones((b, m, 1), np.float32)], -1),
            "crops": rng.normal(size=(b, m, crop_size, crop_size, 3)).astype(np.float32),
        }

    def __iter__(self):
        while True:
            yield self.batch
