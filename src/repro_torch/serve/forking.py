"""Fork-DAG bookkeeping and replay validation for COW sequence forking
(port of ``repro.serve.forking``).

The device side needs no refcounts — the reachability sweep frees a page
exactly when no live table version references it.  What the device side
cannot give is *checking*:

* :func:`page_refcounts` recomputes per-page reference counts from the
  table versions, so a run can assert refcount == reachability
  (:func:`check_no_leak`);
* :class:`ForkDAG` keeps the lineage the device arrays erase: which slot
  forked from which, at what timestamp and prefix length;
* :class:`ForkValidator` holds a child's pre-fork prefix byte-stable
  against the parent's content at fork time, however both sides append,
  fork further or collect in between.

The helpers read tables and pages on the host with numpy, as the JAX
package does; each copies the tensors it needs to the host once per call.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.mvgc.pool import EMPTY
from repro_torch.mvkv.paged import NO_PAGE, PagedKV

__all__ = [
    "ForkDAG",
    "ForkValidator",
    "check_no_leak",
    "page_refcounts",
    "prefix_values",
    "shared_page_count",
]


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


# ---------------------------------------------------------------------------
# Page accounting (host-side ground truth the device sweep must agree with)
# ---------------------------------------------------------------------------
def page_refcounts(st: PagedKV) -> np.ndarray:
    """i32[num_pages]: how many live table versions reference each page —
    the refcount a copying implementation would keep, recomputed as the
    independent oracle of the refcount-free sweep."""
    refs = np.where(_host(st.table_free)[:, None], NO_PAGE,
                    _host(st.tables)).reshape(-1)
    refs = refs[refs >= 0]
    return np.bincount(refs, minlength=st.free.shape[0]).astype(np.int32)


def check_no_leak(st: PagedKV) -> Tuple[bool, np.ndarray, np.ndarray]:
    """The fork-DAG safety invariant: a page is free iff its refcount is 0.
    Returns ``(ok, leaked, premature)``: *leaked* pages are unreferenced
    yet live, *premature* pages referenced yet free."""
    refs = page_refcounts(st)
    free = _host(st.free)
    leaked = np.flatnonzero((refs == 0) & ~free)
    premature = np.flatnonzero((refs > 0) & free)
    return leaked.size == 0 and premature.size == 0, leaked, premature


def shared_page_count(st: PagedKV) -> int:
    """Pages referenced by the table versions of more than one sequence
    slot — COW fork sharing, which the eager-copy control cannot have (a
    version chain's sharing within one slot is excluded): the
    ``pages_shared_peak`` metric of BENCH_fork rows."""
    payload = _host(st.mv.store.payload)              # [S, V] table indices
    live = _host(st.mv.store.ts) != EMPTY
    tables = _host(st.tables)
    table_free = _host(st.table_free)
    owners = np.zeros((st.free.shape[0],), np.int32)
    for s in range(payload.shape[0]):
        rows = payload[s][live[s]]
        rows = rows[(rows >= 0) & ~table_free[rows]]
        pages = np.unique(tables[rows])
        owners[pages[pages >= 0]] += 1
    return int((owners > 1).sum())


def prefix_values(st: PagedKV, table_row: np.ndarray, length: int) -> tuple:
    """Exact K values (head 0, channel 0) of the first ``length`` tokens
    under ``table_row`` — the byte-stability fingerprint: content, not page
    ids.  bfloat16 pages widen to float32, which is exact."""
    ps = st.page_size
    j = np.arange(int(length))
    dev = st.k_pages.device
    pages = torch.as_tensor(np.asarray(table_row)[j // ps].astype(np.int64),
                            device=dev)
    # one gather on the device, one copy to the host
    vals = st.k_pages[pages, torch.as_tensor(j % ps, device=dev), 0, 0]
    return tuple(vals.float().cpu().numpy().tolist())


# ---------------------------------------------------------------------------
# The host-side lineage DAG
# ---------------------------------------------------------------------------
@dataclass
class _Node:
    parent: Optional[int]       # slot id of the parent at fork time
    fork_ts: int                # version-store ts of the child's first version
    fork_len: int               # prefix length shared with the parent


@dataclass
class ForkDAG:
    """Parent-pointer DAG over sequence slots; a release drops the node.
    Slots are reused, so nodes are keyed by slot id; the device sweep, not
    this structure, decides page lifetime."""
    nodes: Dict[int, _Node] = field(default_factory=dict)
    forks: int = 0
    joins: int = 0
    releases: int = 0

    def fork(self, parent: int, child: int, fork_ts: int,
             fork_len: int) -> None:
        self.nodes[child] = _Node(parent, int(fork_ts), int(fork_len))
        self.forks += 1

    def join(self, child: int, parent: int) -> None:
        """Child's content adopted by the parent; grandchildren are
        re-parented to the join target."""
        for node in self.nodes.values():
            if node.parent == child:
                node.parent = parent
        self.nodes.pop(child, None)
        self.joins += 1

    def release(self, slot: int) -> None:
        for node in self.nodes.values():
            if node.parent == slot:
                node.parent = None
        self.nodes.pop(slot, None)
        self.releases += 1

    def ancestors(self, slot: int) -> List[int]:
        out: List[int] = []
        seen = {slot}
        node = self.nodes.get(slot)
        while node is not None and node.parent is not None:
            if node.parent in seen:   # never loop on a corrupted DAG
                break
            out.append(node.parent)
            seen.add(node.parent)
            node = self.nodes.get(node.parent)
        return out

    def descendants(self, slot: int) -> List[int]:
        out = [c for c, n in self.nodes.items() if n.parent == slot]
        i = 0
        while i < len(out):
            out.extend(c for c, n in self.nodes.items()
                       if n.parent == out[i] and c not in out)
            i += 1
        return out

    def as_dict(self) -> Dict[str, Any]:
        """JSON-serialisable form for ``checkpoint()`` round trips."""
        return {
            "nodes": {str(slot): [node.parent, node.fork_ts, node.fork_len]
                      for slot, node in self.nodes.items()},
            "forks": self.forks,
            "joins": self.joins,
            "releases": self.releases,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ForkDAG":
        """Inverse of :meth:`as_dict`; JSON made the slot keys strings."""
        dag = cls(forks=int(d.get("forks", 0)), joins=int(d.get("joins", 0)),
                  releases=int(d.get("releases", 0)))
        for slot, (parent, fork_ts, fork_len) in d.get("nodes", {}).items():
            dag.nodes[int(slot)] = _Node(
                None if parent is None else int(parent),
                int(fork_ts), int(fork_len))
        return dag


# ---------------------------------------------------------------------------
# Replay validation over the DAG
# ---------------------------------------------------------------------------
class ForkValidator:
    """Byte-stability replay checking for fork DAGs: at fork time record
    the child's inherited prefix; at every later check the child's current
    view must reproduce it exactly while the child is live."""

    def __init__(self, keep_examples: int = 5):
        self.keep_examples = keep_examples
        self.checked = 0
        self.violations = 0
        self.examples: List[Dict[str, Any]] = []
        self._expect: Dict[int, tuple] = {}

    def note_fork(self, st: PagedKV, child: int, table_row: np.ndarray,
                  fork_len: int) -> None:
        """Record the inherited prefix from the child's own just-committed
        table row (it reads the shared pages the validator guards)."""
        self._expect[int(child)] = prefix_values(st, table_row, fork_len)

    def drop(self, child: int) -> None:
        """The child was released, joined or reset: its obligation ends."""
        self._expect.pop(int(child), None)

    def check(self, st: PagedKV, child: int, table_row: np.ndarray,
              length: int) -> bool:
        """Compare the child's current view against its recorded prefix."""
        want = self._expect.get(int(child))
        if want is None:
            return True
        self.checked += 1
        n = min(len(want), int(length))
        got = prefix_values(st, table_row, n)
        ok = got == want[:n] and int(length) >= len(want)
        if not ok:
            self.violations += 1
            if len(self.examples) < self.keep_examples:
                self.examples.append({
                    "child": int(child), "want": want[:n], "got": got,
                    "length": int(length), "fork_len": len(want),
                })
        return ok
