"""Fragment datasets (``nmrgnn_tpu/data/dataset.py``): TFRecord fragments
-> padded, batched training samples, as numpy arrays on the host.

A sample is ``(Graph, y f32[N, 3], w f32[N])`` with ``y = (shift,
name_idx, weight flag)``. ``split_dataset`` puts the first ``validation``
share of each file into validation (the reference's per-file take/skip).
``FragmentLoader`` pads each fragment to ``pad_to`` atoms and batches
them, in an order drawn from a seeded numpy generator, staging the next
batch on a thread while the caller uses the current one; a ragged last
batch repeats its last sample with zero weight.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from ..graph import Graph, inv_degree_from_nlist
from .tfrecord import TFRecordWriter, read_examples


@dataclasses.dataclass
class Sample:
    graph: Graph   # numpy-backed
    y: np.ndarray  # f32[N, 3]
    w: np.ndarray  # f32[N]

    @property
    def n(self) -> int:
        return self.y.shape[0]


def write_fragment(
    writer: TFRecordWriter,
    atom_idx: np.ndarray,      # i64[N] element vocabulary indices
    nlist: np.ndarray,         # i[N, K]
    edges: np.ndarray,         # f[N, K]
    shift: np.ndarray,         # f[N]
    name_idx: np.ndarray,      # i[N]
    label_weight: np.ndarray,  # f[N]
    weight: np.ndarray,        # f[N]
) -> None:
    n, k = nlist.shape
    writer.write_example({
        "atoms": np.asarray(atom_idx, np.int64),
        "nlist": np.asarray(nlist, np.int64).ravel(),
        "edges": np.asarray(edges, np.float32).ravel(),
        "shift": np.asarray(shift, np.float32),
        "name_idx": np.asarray(name_idx, np.int64),
        "label_weight": np.asarray(label_weight, np.float32),
        "weight": np.asarray(weight, np.float32),
        "k": np.asarray([k], np.int64),
    })


_EXPECTED_KEYS = ("atoms", "nlist", "edges", "shift", "name_idx", "label_weight", "weight")


def example_to_sample(ex: dict, num_elements: int) -> Sample:
    """A decoded fragment record as a Sample; raises ValueError on a record
    of another schema or with element indices outside the vocabulary."""
    missing = [k for k in _EXPECTED_KEYS if k not in ex]
    if missing:
        raise ValueError(
            f"fragment record is missing fields {missing}; found keys {sorted(ex)}. "
            "A TFRecord of another schema must be converted with a field mapping "
            "(data/fragment.py writes the expected per-atom arrays)."
        )
    atom_idx = np.asarray(ex["atoms"], np.int64)
    n = atom_idx.shape[0]
    k = int(ex["k"][0]) if "k" in ex else ex["nlist"].shape[0] // n
    if atom_idx.size and (atom_idx.min() < 0 or atom_idx.max() >= num_elements):
        bad = atom_idx[(atom_idx < 0) | (atom_idx >= num_elements)]
        raise ValueError(
            f"fragment record has element indices outside the {num_elements}-element "
            f"vocabulary (e.g. {bad[:5].tolist()}); convert it explicitly"
        )
    atoms = np.zeros((n, num_elements), np.float32)
    atoms[np.arange(n), atom_idx] = 1.0
    nlist = np.asarray(ex["nlist"], np.int64).reshape(n, k).astype(np.int32)
    edges = np.asarray(ex["edges"], np.float32).reshape(n, k)
    y = np.stack([np.asarray(ex["shift"], np.float32),
                  np.asarray(ex["name_idx"], np.float32),
                  np.asarray(ex["label_weight"], np.float32)], axis=1)
    w = np.asarray(ex["weight"], np.float32)
    g = Graph(atoms=atoms, nlist=nlist, edges=edges, inv_degree=inv_degree_from_nlist(nlist))
    return Sample(graph=g, y=y, w=w)


def read_fragments(path: str, num_elements: int = 10) -> Iterator[Sample]:
    for ex in read_examples(path):
        yield example_to_sample(ex, num_elements)


def pad_sample(s: Sample, pad_to: int) -> Sample:
    """The sample padded with inert atoms (zeros) to ``pad_to`` rows."""
    n = s.n
    if n > pad_to:
        raise ValueError(f"fragment with {n} atoms > pad_to={pad_to}")
    p = pad_to - n
    if p == 0:
        return s
    g = s.graph
    return Sample(
        graph=Graph(atoms=np.pad(g.atoms, ((0, p), (0, 0))),
                    nlist=np.pad(g.nlist, ((0, p), (0, 0))),
                    edges=np.pad(g.edges, ((0, p), (0, 0))),
                    inv_degree=np.pad(g.inv_degree, ((0, p),))),
        y=np.pad(s.y, ((0, p), (0, 0))),
        w=np.pad(s.w, ((0, p),)),
    )


def batch_samples(samples: Sequence[Sample], pad_to: int) -> Tuple[Graph, np.ndarray, np.ndarray]:
    """(Graph[B, pad_to, ...], y [B, pad_to, 3], w [B, pad_to])."""
    padded = [pad_sample(s, pad_to) for s in samples]
    graph = Graph(*[np.stack([getattr(s.graph, f) for s in padded]) for f in Graph._fields])
    return graph, np.stack([s.y for s in padded]), np.stack([s.w for s in padded])


def split_dataset(paths: Sequence[str], validation: float,
                  num_elements: int = 10) -> Tuple[List[Sample], List[Sample]]:
    """(train, validation): the first ``validation`` share of each file's
    records goes to validation, the rest to training."""
    train: List[Sample] = []
    val: List[Sample] = []
    for p in paths:
        samples = list(read_fragments(p, num_elements))
        vs = int(validation * len(samples))
        val.extend(samples[:vs])
        train.extend(samples[vs:])
    return train, val


class FragmentLoader:
    """Batches of padded fragments, shuffled each epoch by a numpy
    generator seeded with ``seed`` (the JAX package's order for the same
    seed), the next batch staged on a thread while the caller holds the
    current one."""

    def __init__(self, samples: Sequence[Sample], pad_to: int = 256, batch_size: int = 8,
                 shuffle: bool = True, seed: int = 0, drop_remainder: bool = False):
        if not samples:
            raise ValueError("empty dataset")
        self.samples = list(samples)
        self.pad_to = pad_to
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.samples)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_order(self) -> np.ndarray:
        """This epoch's sample order (one draw of the generator when
        shuffling)."""
        order = np.arange(len(self.samples))
        if self.shuffle:
            self._rng.shuffle(order)
        return order

    def _stage(self, idx_chunk) -> Tuple[Graph, np.ndarray, np.ndarray]:
        group = [self.samples[i] for i in idx_chunk]
        n_real = len(group)
        group += [group[-1]] * (self.batch_size - n_real)
        g, y, w = batch_samples(group, self.pad_to)
        if n_real < self.batch_size:  # the repeated copies weigh nothing
            w = w.copy()
            w[n_real:] = 0.0
            y = y.copy()
            y[n_real:, :, 2] = 0.0
        return g, y, w

    def batches(self) -> Iterator[Tuple[Graph, np.ndarray, np.ndarray]]:
        order = self._epoch_order()
        bs = self.batch_size
        stop = len(order) - (len(order) % bs) if self.drop_remainder else len(order)
        chunks = [order[i:i + bs] for i in range(0, stop, bs)]
        if not chunks:
            return
        nxt = self._stage(chunks[0])
        for i in range(len(chunks)):
            cur = nxt
            holder = {}

            def work(j=i + 1):
                try:
                    holder["v"] = self._stage(chunks[j])
                except BaseException as e:  # re-raised on the caller's thread
                    holder["e"] = e

            t = threading.Thread(target=work) if i + 1 < len(chunks) else None
            if t is not None:
                t.start()
            try:
                yield cur
            finally:
                if t is not None:
                    t.join()
            if "e" in holder:
                raise holder["e"]
            nxt = holder.get("v")
