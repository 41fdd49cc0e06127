"""Fork-DAG bookkeeping for COW sequence forking (port of the ``ForkDAG``
of ``repro.serve.forking``; plain Python, no tensors).

The device side needs no refcounts — the reachability sweep frees a page
exactly when no live table version references it.  :class:`ForkDAG` keeps
the lineage the device arrays erase: which slot forked from which, at what
timestamp and prefix length.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class _Node:
    parent: Optional[int]       # slot id of the parent at fork time
    fork_ts: int                # version-store ts of the child's first version
    fork_len: int               # prefix length shared with the parent


@dataclass
class ForkDAG:
    """Parent-pointer DAG over sequence slots; a release drops the node."""
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

    def as_dict(self) -> Dict[str, Any]:
        """JSON-serialisable form."""
        return {
            "nodes": {str(slot): [node.parent, node.fork_ts, node.fork_len]
                      for slot, node in self.nodes.items()},
            "forks": self.forks,
            "joins": self.joins,
            "releases": self.releases,
        }
