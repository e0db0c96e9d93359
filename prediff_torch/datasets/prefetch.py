"""Host -> device input pipeline: a producer thread stages each batch in
pinned host memory and copies it to the card on a side CUDA stream, keeping
up to ``size`` batches in flight, so HDF5 reads and augmentation on the host
overlap the steps on the card.

Counterpart of ``prediff_tpu/datasets/prefetch.py``.  Its ``sharding``
takes a ``parallel.DataMesh``: each batch's rows of this rank
(``local_batch_slice``) go to the rank's device, where JAX puts the batch
across the mesh.  :func:`stack_chunks` stacks K host batches into one (K, B,
...) chunk, the input of ``steps_per_call`` (``training.fit``), so a chunk
crosses to the card in one copy a leaf.
"""
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..parallel.mesh import DataMesh, local_batch_slice
from ..utils.device import resolve_device


def _map(fn, item):
    """``fn`` over the leaves of a batch (a tensor or array, or tuples,
    lists and dicts of them)."""
    if isinstance(item, (tuple, list)):
        return type(item)(_map(fn, x) for x in item)
    if isinstance(item, dict):
        return {k: _map(fn, v) for k, v in item.items()}
    return fn(item)


def _tensor(x) -> torch.Tensor:
    """A tensor over ``x`` (no copy where numpy's layout allows it)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.require(x, requirements="C"))


def pinned(t: torch.Tensor) -> torch.Tensor:
    """A page-locked host copy of ``t``: the source of an asynchronous copy
    to the card."""
    return t.pin_memory()


def stack_chunks(iterator: Iterable, k: int) -> Iterator:
    """The batches of ``iterator`` (arrays or tensors, or tuples / lists of
    them) stacked k at a time on the host along a new leading axis; a ragged
    tail of fewer than k is dropped, as a ragged batch is (the JAX training
    script's ``chunked``)."""
    buf = []
    for item in iterator:
        buf.append(item)
        if len(buf) == k:
            if isinstance(buf[0], (tuple, list)):
                yield type(buf[0])(np.stack([np.asarray(b[i]) for b in buf])
                                   for i in range(len(buf[0])))
            else:
                yield np.stack([np.asarray(b) for b in buf])
            buf = []


def prefetch_to_device(iterator: Iterable, size: int = 2, device=None,
                       transform: Optional[Callable] = None,
                       sharding: Optional[DataMesh] = None) -> Iterator:
    """Yield the batches of ``iterator`` (numpy arrays or tensors, or tuples,
    lists and dicts of them) as tensors on ``device`` (``None``: the card,
    or the mesh's device with ``sharding``), keeping up to ``size`` in
    flight.  ``transform`` runs on the host in the producer thread
    (augmentation, layout slicing).  With ``sharding`` (a ``DataMesh``) each
    leaf keeps this rank's rows of its leading axis, cut on the host before
    the copy.

    On the card each leaf goes through pinned memory to the device by a
    non-blocking copy on a side stream; the consumer's stream waits on an
    event recorded after the copies, and each tensor is recorded on the
    consumer's stream so the allocator does not hand its memory out while
    the consumer's work may still read it.  On ``"cpu"`` the leaves become
    plain tensors.  An error in the producer is raised again in the
    consumer; the producer stops when the generator is closed or collected.
    """
    dev = resolve_device(sharding.device if device is None and sharding is not None else device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    error = []
    stop = threading.Event()

    def put(item) -> bool:
        """Enqueue unless the consumer has gone away (the generator closed
        mid-epoch); otherwise the producer would block forever holding
        ``size`` device batches."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def rows(t):
        return t[local_batch_slice(t.shape[0], sharding.size, sharding.index)]

    def stage(item):
        item = _map(_tensor, item)
        if sharding is not None:
            item = _map(rows, item)
        if side is None:
            return item, None
        with torch.cuda.stream(side):
            item = _map(lambda t: pinned(t).to(dev, non_blocking=True), item)
            done = torch.cuda.Event()
            done.record(side)
        return item, done

    def producer():
        try:
            for item in iterator:
                if transform is not None:
                    item = transform(item)
                if not put(stage(item)):
                    return
        except BaseException as e:  # raised again in the consumer, not swallowed
            error.append(e)
        finally:
            put(sentinel)

    thread = threading.Thread(target=producer, name="prefetch_to_device", daemon=True)
    thread.start()
    try:
        while True:
            got = q.get()
            if got is sentinel:
                if error:
                    raise error[0]
                break
            item, done = got
            if done is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(done)
                _map(lambda t: t.record_stream(consumer), item)
            yield item
    finally:
        stop.set()  # runs on close() / collection of an abandoned generator too
        while not q.empty():  # release the device batches still queued
            try:
                q.get_nowait()
            except queue.Empty:
                break
