"""A vector store on the card: brute-force exact top-k over a resident
matrix.

Port of ``langstream_tpu/agents/vectorstore.py``. The embeddings live in
a device matrix and a search is one matrix-vector product and one top-k
on the card: exact, and for corpora up to a few million vectors faster
end to end than a network round trip to an ANN service.

- The host keeps the authoritative ``float32`` matrix (padded to a power
  of two of rows, so growth is amortised) for persistence and for the
  plain numpy path. The card keeps a copy of it: rows that ``upsert`` or
  ``delete`` change are marked dirty and uploaded once, before the next
  search, so a search moves no corpus across PCIe. A growth of the
  matrix (or a load) uploads it whole at the next search.
- A search scores ``matrix @ q`` (``cosine``, ``dot``; stored and query
  vectors are unit-normalised for ``cosine``) or ``-sum((m - q)^2)``
  (``l2``), masks padding rows to ``-inf`` and ranks the top ``k`` as
  ``lax.top_k`` does: the larger score first, the lower row first on a
  tie. The JAX store's ``_search_jax``, with the same scores and rows.
- ``use_torch=False`` searches the host matrix with numpy instead (the
  JAX store's ``use_jax=False``; its ``l2`` score is ``-norm``).
- ``flush`` writes ``<persist_path>.npz`` and ``<persist_path>.meta.json``
  in the JAX store's format, so a store written by either package loads
  in the other.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from langstream_tpu_torch.agents.datasource import DataSource, _substitute
from langstream_tpu_torch.device import resolve_device
from langstream_tpu_torch.providers.torch_local.sampling import lax_top_k


def _next_pow2(n: int) -> int:
    size = 1
    while size < n:
        size *= 2
    return size


class VectorStore:
    def __init__(
        self,
        dimensions: int,
        *,
        metric: str = "cosine",
        persist_path: Optional[str] = None,
        use_torch: bool = True,
        device: Any = "cuda",
    ) -> None:
        if metric not in ("cosine", "dot", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        self.dimensions = dimensions
        self.metric = metric
        self.persist_path = persist_path
        self.use_torch = use_torch
        self.device = resolve_device(device) if use_torch else None
        self._ids: List[str] = []
        self._index: Dict[str, int] = {}
        self._meta: Dict[str, Dict[str, Any]] = {}
        self._matrix = np.zeros((0, dimensions), dtype=np.float32)
        self._lock = threading.Lock()
        # the card's copy: None until the first search (and after a growth
        # or a load); rows changed since the last upload
        self._resident: Optional[torch.Tensor] = None
        self._dirty: set = set()
        if persist_path and os.path.exists(persist_path + ".npz"):
            self._load()

    def __len__(self) -> int:
        return len(self._ids)

    # ------------------------------------------------------------------ #
    # mutation
    # ------------------------------------------------------------------ #
    def upsert(
        self,
        doc_id: str,
        vector: List[float],
        metadata: Optional[Dict[str, Any]] = None,
    ) -> None:
        array = np.asarray(vector, dtype=np.float32)
        if array.shape != (self.dimensions,):
            raise ValueError(
                f"vector has shape {array.shape}, store expects ({self.dimensions},)"
            )
        if self.metric == "cosine":
            norm = float(np.linalg.norm(array)) or 1.0
            array = array / norm
        with self._lock:
            row = self._index.get(doc_id)
            if row is None:
                row = len(self._ids)
                self._ids.append(doc_id)
                self._index[doc_id] = row
                if row >= self._matrix.shape[0]:
                    grown = np.zeros(
                        (_next_pow2(row + 1), self.dimensions), dtype=np.float32
                    )
                    grown[: self._matrix.shape[0]] = self._matrix
                    self._matrix = grown
                    self._resident = None  # uploaded whole at the next search
            self._matrix[row] = array
            self._dirty.add(row)
            self._meta[doc_id] = metadata or {}

    def delete(self, doc_id: str) -> bool:
        with self._lock:
            row = self._index.pop(doc_id, None)
            if row is None:
                return False
            last = len(self._ids) - 1
            last_id = self._ids[last]
            # swap-delete keeps the matrix dense
            self._matrix[row] = self._matrix[last]
            self._matrix[last] = 0.0
            self._dirty.update((row, last))
            self._ids[row] = last_id
            self._ids.pop()
            if last_id != doc_id:
                self._index[last_id] = row
            self._meta.pop(doc_id, None)
            return True

    # ------------------------------------------------------------------ #
    # search
    # ------------------------------------------------------------------ #
    def search(
        self, vector: List[float], top_k: int = 10
    ) -> List[Dict[str, Any]]:
        query = np.asarray(vector, dtype=np.float32)
        if self.metric == "cosine":
            norm = float(np.linalg.norm(query)) or 1.0
            query = query / norm
        with self._lock:
            count = len(self._ids)
            if count == 0:
                return []
            k = min(top_k, count)
            if self.use_torch:
                scores, indices = self._search_torch(query, k, count)
            else:
                scores, indices = self._search_numpy(query, k, count)
            out = []
            for score, row in zip(scores, indices):
                doc_id = self._ids[int(row)]
                record = {"id": doc_id, "similarity": float(score)}
                record.update(self._meta.get(doc_id, {}))
                out.append(record)
            return out

    def _search_numpy(self, query, k, count):
        matrix = self._matrix[:count]
        if self.metric == "l2":
            scores = -np.linalg.norm(matrix - query, axis=1)
        else:
            scores = matrix @ query
        order = np.argsort(-scores)[:k]
        return scores[order], order

    def _sync(self) -> torch.Tensor:
        """The card's copy of the matrix, brought up to date: uploaded
        whole after a growth or a load (or when most rows changed), else
        only the dirty rows. Called under the lock."""
        rows = self._matrix.shape[0]
        if self._resident is None or len(self._dirty) * 2 >= rows:
            self._resident = torch.from_numpy(self._matrix).to(self.device, copy=True)
        elif self._dirty:
            index = np.fromiter(self._dirty, dtype=np.int64, count=len(self._dirty))
            self._resident.index_copy_(
                0, torch.from_numpy(index).to(self.device),
                torch.from_numpy(self._matrix[index]).to(self.device))
        self._dirty.clear()
        return self._resident

    def _search_torch(self, query, k, count):
        matrix = self._sync()
        q = torch.from_numpy(query).to(self.device)
        if self.metric == "l2":
            scores = -((matrix - q) ** 2).sum(1)
        else:
            scores = matrix @ q
        # mask padding rows out of the ranking
        padding = torch.arange(matrix.shape[0], device=self.device) >= count
        scores = scores.masked_fill(padding, float("-inf"))
        top, rows = lax_top_k(scores, k)
        return top.cpu().numpy(), rows.cpu().numpy()

    # ------------------------------------------------------------------ #
    # persistence (checkpoint/resume for agents with disks)
    # ------------------------------------------------------------------ #
    def flush(self) -> None:
        if not self.persist_path:
            return
        os.makedirs(os.path.dirname(self.persist_path) or ".", exist_ok=True)
        with self._lock:
            count = len(self._ids)
            np.savez_compressed(
                self.persist_path + ".npz", matrix=self._matrix[:count]
            )
            with open(self.persist_path + ".meta.json", "w", encoding="utf-8") as f:
                json.dump(
                    {"ids": self._ids, "meta": self._meta, "metric": self.metric},
                    f,
                    ensure_ascii=False,
                    default=str,
                )

    def _load(self) -> None:
        with np.load(self.persist_path + ".npz") as data:
            matrix = data["matrix"]
        with open(self.persist_path + ".meta.json", "r", encoding="utf-8") as f:
            payload = json.load(f)
        self._ids = list(payload["ids"])
        self._meta = dict(payload["meta"])
        self._index = {doc_id: i for i, doc_id in enumerate(self._ids)}
        rows = _next_pow2(max(1, matrix.shape[0]))
        self._matrix = np.zeros((rows, self.dimensions), dtype=np.float32)
        self._matrix[: matrix.shape[0]] = matrix
        self._resident = None
        self._dirty.clear()


_SHARED_STORES: Dict[str, VectorStore] = {}
_SHARED_LOCK = threading.Lock()


def shared_store(name: str, dimensions: int, **kwargs) -> VectorStore:
    """Named stores shared across agents of one process (writer agent and
    query agent see the same corpus, like a shared external DB)."""
    with _SHARED_LOCK:
        store = _SHARED_STORES.get(name)
        if store is None:
            store = VectorStore(dimensions, **kwargs)
            _SHARED_STORES[name] = store
        return store


class VectorStoreDataSource(DataSource):
    """Datasource adapter: JSON query specs against a named store on
    ``device``: the app's, which the :class:`DataSourceRegistry
    <langstream_tpu_torch.agents.datasource.DataSourceRegistry>` hands
    it, the card unless the caller asks for the CPU.

    Query spec: ``{"action": "search", "vector": ?, "top-k": 5}`` or
    ``{"action": "upsert", "id": ?, "vector": ?, "metadata": {...}}`` —
    ``?`` placeholders fill from params in order.
    """

    def __init__(self, config: Dict[str, Any], device: Any = "cuda") -> None:
        self.store = shared_store(
            config.get("name", "default"),
            int(config.get("dimensions", 384)),
            metric=config.get("metric", "cosine"),
            persist_path=config.get("persist-path"),
            device=device,
        )

    async def query(self, query: str, params: List[Any]) -> List[Dict[str, Any]]:
        spec = _fill(query, params)
        action = spec.get("action", "search")
        if action != "search":
            raise ValueError("vector datasource query only supports 'search'")
        return self.store.search(spec["vector"], int(spec.get("top-k", 10)))

    async def execute(self, statement: str, params: List[Any]) -> Dict[str, Any]:
        spec = _fill(statement, params)
        action = spec.get("action")
        if action == "upsert":
            self.store.upsert(str(spec["id"]), spec["vector"], spec.get("metadata"))
            self.store.flush()
            return {"rowcount": 1}
        if action == "delete":
            deleted = self.store.delete(str(spec["id"]))
            self.store.flush()
            return {"rowcount": int(deleted)}
        raise ValueError(f"unsupported vector action {action!r}")


def _fill(query: str, params: List[Any]) -> Dict[str, Any]:
    return json.loads(_substitute(query, params))
