"""DataLoader: shuffled batching, collation to host Batch, padding to static
GraphBatch capacities, infinite auto-resetting iterators, per-process file
sharding.

PyTorch counterpart of ``equivariant_nn_zoo_tpu/data/dataloader.py`` with
its padded layout only (the tile-aligned layout is the TPU kernels' and is
not ported; the JAX loader makes it on the TPU alone, so elsewhere both
loaders make the same batches).  The semantics that decide which graphs
land in which batch are the JAX loader's: the shuffle stream
(``np.random.default_rng(seed)``), ``drop_last``, overflow deferral and the
epoch carry, the thread-pool preprocess with its timeout and the prefetch
thread.  Batches are host batches (CPU tensors); with ``pin_memory`` the
consuming thread pins them, so that a trainer copies them to the card
asynchronously.  No thread of the loader touches the card.

With ``num_shards`` N > 1 the loader is one rank's share of a loader of
global batches of ``batch_size``: every rank shuffles alike (the same
seed), cuts each global batch into N consecutive parts as the JAX loader
cuts it for the devices of its mesh, and reads, preprocesses and pads
only part ``shard_index`` (``batch_size / N`` graphs).
"""

from __future__ import annotations

import logging
import math
import queue
import threading
from typing import List

import numpy as np

from .batch import Batch
from .data import Data
from .graph_batch import GraphBatch


class Collater:
    """Reference parity: dataloader.py:13-28."""

    @classmethod
    def for_dataset(cls, dataset):
        return cls()

    def collate(self, batch: List[Data]) -> Batch:
        return Batch.from_data_list(batch, attrs=dict(batch[0].attrs))

    def __call__(self, batch):
        return self.collate(batch)


def estimate_capacities(dataset, batch_size: int, sample: int = 256,
                        headroom: float = None, multiple: int = 128):
    """Estimate static (node, edge) capacities from a dataset sample.

    Capacity = batch_size * mean-per-graph * headroom, rounded up; one node
    slot is reserved for the dummy node.  Graphs that overflow are carried
    to the next batch by the loader (or dropped and counted when one graph
    alone does not fit), never silently.
    """
    if headroom is None:
        # batch sums concentrate as ~1/sqrt(B); small batches need more slack
        headroom = 1.1 + 2.0 / (batch_size ** 0.5)
    n = min(len(dataset), sample)
    idx = np.linspace(0, len(dataset) - 1, n).astype(np.int64)
    nodes, edges = [], []
    for i in idx:
        item = dataset[int(i)]
        if "_n_nodes" in item:
            nodes.append(int(np.asarray(item["_n_nodes"]).sum()))
        else:  # bare Data: count rows of any node-annotated key
            per_node = [k for k, (per, _) in item.attrs.items()
                        if per == "node"]
            nodes.append(int(np.asarray(item[per_node[0]]).shape[0]))
        if "_n_edges" in item:
            edges.append(int(np.asarray(item["_n_edges"]).sum()))
        elif "edge_index" in item:
            edges.append(int(np.asarray(item["edge_index"]).shape[-1]))
        else:
            edges.append(0)

    def round_up(x):
        return int(math.ceil(x / multiple) * multiple)

    node_cap = round_up(batch_size * float(np.mean(nodes)) * headroom + 1)
    node_cap = max(node_cap, round_up(max(nodes) + 1))
    edge_cap = round_up(max(batch_size * float(np.mean(edges)) * headroom, 1))
    edge_cap = max(edge_cap, round_up(max(edges) + 1))
    return node_cap, edge_cap


def _worker_get(dataset, idx_chunk):
    return [dataset[i] for i in idx_chunk]


class DataLoader:
    """Iterates padded host GraphBatches over a CondensedDataset."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 seed: int = 0, node_capacity: int = None,
                 edge_capacity: int = None, drop_last: bool = True,
                 prefetch: int = 2, num_workers: int = 0,
                 worker_timeout: float = 120.0, pin_memory: bool = False,
                 num_shards: int = 1, shard_index: int = 0, **kwargs):
        if batch_size % num_shards:
            raise ValueError(f"batch_size {batch_size} does not divide "
                             f"into {num_shards} shards")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_shards, self.shard_index = num_shards, shard_index
        # the graphs of this shard's part of a batch
        self.part = batch_size // num_shards
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.collater = Collater.for_dataset(dataset)
        if node_capacity is None or edge_capacity is None:
            node_capacity, edge_capacity = estimate_capacities(
                dataset, self.part)
        self.node_capacity = node_capacity
        self.edge_capacity = edge_capacity
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.num_workers = int(num_workers or 0)
        self.worker_timeout = worker_timeout
        self._pool = None
        if self.num_workers > 0:
            # threads, not processes: items are small and numpy-rich, and
            # numpy releases the GIL in the distance and sort kernels
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=self.num_workers, thread_name_prefix="e3loader")
        self.dropped_graphs = 0
        # graphs deferred past the epoch's last batch lead the next epoch's
        # first batch; in memory only (a resume starts with an empty carry)
        self._carry: List = []

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_batch_items(self, items) -> GraphBatch:
        return GraphBatch.from_batch(
            self.collater(items), self.node_capacity, self.edge_capacity,
            self.part, device="cpu")

    def _index_batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        first = self.shard_index * self.part
        for b in range(len(self)):
            batch = order[b * self.batch_size: (b + 1) * self.batch_size]
            yield batch[first: first + self.part]

    # ------------------------------------------------ parallel item pipeline

    def _item_stream(self):
        """Preprocessed items in index order.  With ``num_workers`` > 0 the
        per-item preprocessing runs on a thread pool in chunks, with a
        lookahead window and a timeout guard; batch assembly (collate, pad,
        deferral) stays sequential, so the batches are the serial loader's.
        The timeout aborts the loader; a hung preprocess thread cannot be
        cancelled."""
        flat = (int(i) for idx in self._index_batches() for i in idx)
        if self.num_workers <= 0:
            for i in flat:
                yield self.dataset[i]
            return
        import collections

        # chunked tasks: per-item futures drown in pool round trips
        chunk = max(8, self.part // max(1, self.num_workers))
        lookahead = 2 * self.num_workers + 2
        pending: collections.deque = collections.deque()

        def chunks():
            buf = []
            for i in flat:
                buf.append(i)
                if len(buf) == chunk:
                    yield buf
                    buf = []
            if buf:
                yield buf

        try:
            for c in chunks():
                pending.append(self._pool.submit(_worker_get, self.dataset, c))
                if len(pending) >= lookahead:
                    yield from self._worker_result(pending.popleft())
            while pending:
                yield from self._worker_result(pending.popleft())
        finally:
            while pending:
                pending.popleft().cancel()

    def _worker_result(self, fut):
        from concurrent.futures import TimeoutError

        try:
            return fut.result(timeout=self.worker_timeout)
        except TimeoutError:
            raise RuntimeError(
                f"dataloader worker timed out after {self.worker_timeout}s "
                "(preprocess hang?)")

    def _batches(self):
        """Batches with overflow deferral: graphs that do not fit the
        static capacities are carried to the front of the next batch
        instead of dropped.  Graphs still deferred at the epoch's end stay
        in ``self._carry`` and lead the next epoch's first batch."""
        carry: List = self._carry
        self._carry = []
        items_it = self._item_stream()
        _end = object()
        for _ in range(len(self)):
            # fill from the carry first so the backlog drains
            while len(carry) < self.part:
                item = next(items_it, _end)
                if item is _end:
                    break
                carry.append(item)
            items = carry[: self.part]
            carry = carry[self.part:]
            out = self._make_batch_items(items)
            if out.dropped:
                nd = out.dropped
                if nd < len(items):  # oversize-alone batches drop for real
                    carry = items[len(items) - nd:] + carry
                    out.dropped = 0
                    logging.debug("deferred %d overflow graphs", nd)
            if out.dropped:
                self.dropped_graphs += out.dropped
                logging.warning(
                    f"batch overflowed static capacities; dropped "
                    f"{out.dropped} graphs (total {self.dropped_graphs})")
            yield out
        # the epoch's unconsumed tail leads the next epoch
        carry.extend(items_it)
        if carry:
            self._carry = carry
            logging.info("epoch end: %d deferred graphs carried into the "
                         "next epoch", len(carry))

    def __iter__(self):
        batches = (self._prefetch_iter() if self.prefetch and self.prefetch > 0
                   else self._batches())
        if not self.pin_memory:
            return batches
        return (gb.pin_memory() for gb in batches)

    def _prefetch_iter(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err = []

        def worker():
            try:
                for batch in self._batches():
                    q.put(batch)
            except Exception as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __del__(self):  # best-effort pool cleanup
        try:
            self.close()
        except Exception:
            pass

    def state_dict(self):
        return {"rng": self.rng.bit_generator.state,
                "dropped_graphs": self.dropped_graphs}

    def load_state_dict(self, state):
        self.rng.bit_generator.state = state["rng"]
        self.dropped_graphs = state.get("dropped_graphs", 0)


def shard_paths(path, process_index: int, process_count: int):
    """Partition a list of dataset files across data-parallel processes
    (``rank % gcd`` file sharding)."""
    if not isinstance(path, (list, tuple)):
        return path
    g = math.gcd(process_count, len(path))
    start = (process_index % g) * (len(path) // g)
    end = (process_index % g + 1) * (len(path) // g)
    return list(path)[start:end]


def getDataIters(config: dict, seed: int = 0, process_index: int = 0,
                 process_count: int = 1):
    """Infinite train / validation iterators from a config dict (its
    ``data_config`` and ``batch_size``): file sharding, the split, a
    per-process loader seed, auto-resetting iterators."""
    from .dataset import CondensedDataset
    from ..utils.utils import pruneArgs

    data_config = dict(config["data_config"])
    data_config["path"] = shard_paths(data_config.get("path"), process_index,
                                      process_count)
    dataset = CondensedDataset(**pruneArgs(CondensedDataset, **data_config))

    total_n = len(dataset)
    n_train, n_val = data_config["n_train"], data_config["n_val"]
    if isinstance(n_train, float):
        n_train = int(n_train * total_n)
    if isinstance(n_val, float):
        n_val = int(n_val * total_n)
    if (n_train + n_val) > total_n:
        raise ValueError("too little data for training and validation. "
                         "please reduce n_train and n_val")
    split = data_config.get("train_val_split", "random")
    if split == "random":
        idcs = np.random.default_rng(seed).permutation(total_n)
    elif split == "sequential":
        idcs = np.arange(total_n)
    else:
        raise NotImplementedError(f"splitting mode {split} not implemented")
    train_ds = dataset.index_select(idcs[:n_train])
    eval_ds = dataset.index_select(idcs[n_train: n_train + n_val])

    batch_size = config["batch_size"]
    node_cap, edge_cap = estimate_capacities(train_ds, batch_size)
    # explicit capacity overrides (edges built in the model)
    node_cap = data_config.get("node_capacity") or node_cap
    edge_cap = data_config.get("edge_capacity") or edge_cap
    dl_kwargs = dict(batch_size=batch_size, node_capacity=node_cap,
                     edge_capacity=edge_cap, drop_last=True,
                     seed=seed + process_index,
                     num_workers=data_config.get("num_workers", 0))
    train_dl = DataLoader(train_ds, shuffle=True, **dl_kwargs)
    eval_dl = DataLoader(eval_ds, shuffle=False, **dl_kwargs)
    for name, dl in (("training", train_dl), ("validation", eval_dl)):
        # an endless iterator over no batch would spin without yielding
        if len(dl) == 0:
            raise ValueError(f"the {name} split ({len(dl.dataset)} graphs) "
                             f"holds no batch of {batch_size}")

    def autoReset(dataloader):
        while True:
            yield from iter(dataloader)

    return autoReset(train_dl), autoReset(eval_dl)
