"""A cell's inputs, made from the seed: the pool of partitions (made in
parallel processes and encoded through the program's public columnar API),
the Transform's parameters, and the program's objects built from the
configuration file.  Nothing here imports torch at module level: the run
starts the pool before torch is imported.
"""

from __future__ import annotations

import multiprocessing
import os
import random
import shutil
import tempfile
from typing import Dict, List, Optional

import numpy as np

from presto_bench.traffic import generator


def data_config(cfg: Dict, traffic: Dict) -> Dict:
    """The configuration's data sizes with the traffic's sharing."""
    return dict(cfg["data"], dup_factor=int(traffic.get("dup_factor", 1)))


def start(files: Dict, seed: int, processes: int) -> "Partitions":
    """Start making the pool of partitions of a cell's files (``cfg``,
    ``traffic``)."""
    return Partitions(data_config(files["cfg"], files["traffic"]), seed, files["traffic"],
                      processes)


def _schema(data: Dict):
    from repro_torch.data.columnar import ColumnSchema, PartitionSchema, refs_column

    id_width = max(int(data["id_space"] - 1).bit_length(), 1)
    len_width = max(int(data["max_sparse_len"]).bit_length(), 1)
    cols = [ColumnSchema(f"d{i}", "dense", data["dense_encoding"]) for i in range(data["n_dense"])]
    cols += [ColumnSchema(f"s{i}", "sparse", data["sparse_encoding"], max_len=data["max_sparse_len"],
                          id_width=id_width, len_width=len_width)
             for i in range(data["n_sparse"])]
    cols.append(ColumnSchema("label", "dense", "plain"))
    if data["dup_factor"] > 1:
        cols.append(refs_column())
    return PartitionSchema(rows=data["rows_per_partition"], columns=tuple(cols),
                           dup_factor=data["dup_factor"])


def encode(data: Dict, raw: Dict, fid: int):
    """One raw partition as the program's encoded ``Partition``."""
    from repro_torch.data.columnar import encode_partition

    dense = {f"d{i}": raw["dense"][:, i] for i in range(data["n_dense"])}
    dense["label"] = raw["labels"]
    vals = {f"s{i}": raw["sparse_values"][:, i] for i in range(data["n_sparse"])}
    lens = {f"s{i}": raw["sparse_lengths"][:, i] for i in range(data["n_sparse"])}
    return encode_partition(fid, _schema(data), dense, vals, lens,
                            sparse_refs=raw.get("sparse_refs"))


def raw_partition(data: Dict, seed: int, fid: int) -> Dict:
    """The raw features of file `fid` (``traffic.generator``)."""
    return generator.raw_partition(data, data["rows_per_partition"], seed, fid, data["dup_factor"])


def make_file(data: Dict, seed: int, fid: int, path: Optional[str]):
    """Worker: raw partition `fid`, encoded, written to `path` with the
    program's ``write_partition`` (None returned), or, with no path,
    returned."""
    from repro_torch.data.columnar import write_partition

    part = encode(data, raw_partition(data, seed, fid), fid)
    if path is None:
        return part
    write_partition(path, part)
    return None


class Partitions:
    """The traffic's pool of partitions, made from the seed by ``processes``
    spawned processes while the run goes on (in this process when 1).  A
    traffic whose ``store`` is ``"files"`` has its partitions written as
    files under a new directory of ``TMPDIR``, with further partition ids
    linked to them (``store``); one whose ``store`` is ``"memory"`` gets
    them back encoded (``wait()``).  Only the encoded partitions cross
    between processes: the raw features that the checks need are drawn
    again (``raw``)."""

    def __init__(self, data: Dict, seed: int, traffic: Dict, processes: int):
        self.data, self.seed, self.n_files = data, seed, traffic["files"]
        self.root = self.store = None
        paths = [None] * self.n_files
        if traffic["store"] == "files":
            self.root = tempfile.mkdtemp(prefix="presto_bench_")
            self.store, paths = file_store(self.root, self.n_files, traffic["partition_ids"])
        args = [(data, seed, f, paths[f]) for f in range(self.n_files)]
        self._pool = None
        if processes > 1:
            ctx = multiprocessing.get_context("spawn")
            self._pool = ctx.Pool(processes=min(processes, self.n_files))
            self._pending = self._pool.starmap_async(make_file, args)
        else:
            self._done = [make_file(*a) for a in args]
        self._raw: Dict[int, Dict] = {}

    def wait(self) -> List:
        """Block until every partition is made; the encoded ones (ISP)."""
        if self._pool is not None:
            self._done = self._pending.get()
            self._pool.close()
            self._pool.join()
            self._pool = None
        return self._done

    def raw(self, fid: int) -> Dict:
        if fid not in self._raw:
            self._raw[fid] = raw_partition(self.data, self.seed, fid)
        return self._raw[fid]

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
        if self.root is not None:
            shutil.rmtree(self.root, ignore_errors=True)
            self.root = None


def transform_spec(data: Dict, seed: int):
    """The program's ``TransformSpec`` and the same parameters as numpy."""
    from repro_torch.core.spec import TransformSpec
    from repro_torch.data.synth import RMDataConfig

    params = generator.transform_params(data, seed)
    fields = {k: data[k] for k in ("n_dense", "n_sparse", "avg_sparse_len", "max_sparse_len",
                                   "n_generated", "bucket_size", "id_space", "embedding_rows",
                                   "rows_per_partition", "dense_encoding", "sparse_encoding",
                                   "dup_factor")}
    cfg = RMDataConfig(name=data["name"], **fields)
    spec = TransformSpec(
        cfg=cfg, bucket_boundaries=params["bucket_boundaries"],
        generated_source=tuple(int(i) for i in params["generated_source"]),
        sparse_seeds=params["sparse_seeds"], sparse_max=params["sparse_max"],
        gen_seeds=params["gen_seeds"], gen_max=params["gen_max"])
    return spec, params


def recsys_config(cfg: Dict, spec):
    from repro_torch.models.recsys import RecSysConfig

    m = cfg["model"]
    return RecSysConfig(name=cfg["name"], data=spec.cfg, emb_dim=m["emb_dim"],
                        bottom_mlp=tuple(m["bottom_mlp"]), top_mlp=tuple(m["top_mlp"]),
                        dtype=m["dtype"], param_dtype=m["dtype"])


def file_store(root: str, n_files: int, n_pids: int):
    """A ``PartitionedStore`` of `n_pids` partitions over `root`, pid p a
    link to file p mod `n_files`, returned with the files' paths."""
    from repro_torch.data.storage import PartitionedStore

    store = PartitionedStore(n_pids, num_devices=n_files, root=root)
    paths = [store._path(p) for p in range(n_files)]
    for p in range(n_files, n_pids):
        os.symlink(os.path.basename(paths[p % n_files]), store._path(p))
    return store, paths


class MemorySource:
    """Encoded partitions held in memory, served to a ``PartitionedStore``
    as its source (nothing is written to disk)."""

    def __init__(self, parts):
        self.parts = list(parts)

    def partition(self, pid: int):
        return self.parts[pid]


def memory_store(parts):
    from repro_torch.data.storage import PartitionedStore

    return PartitionedStore(len(parts), num_devices=len(parts), source=MemorySource(parts))


def chosen_files(seed: int, n_files: int, files: int) -> List[int]:
    """`files` of the `n_files` files, drawn from the seed."""
    rng = np.random.default_rng(seed ^ 0xC4EC)
    return sorted(int(f) for f in rng.choice(n_files, size=min(files, n_files), replace=False))


class Sample:
    """`k` items kept uniformly at random from a stream of unknown length (a
    reservoir, its draws from the seed): the window's answers that the check
    judges."""

    def __init__(self, seed: int, k: int):
        self.rng = random.Random(seed ^ 0x5A3F)
        self.k, self.seen, self.items = k, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        r = self.rng.randrange(self.seen)
        if r < self.k:
            self.items[r] = item
