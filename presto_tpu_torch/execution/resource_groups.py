"""Hierarchical resource groups (reference:
presto_tpu/execution/resource_groups.py;
execution/resourceGroups/InternalResourceGroup.java +
presto-resource-group-managers' static selectors in Presto).

A tree of named groups, each with a hard concurrency cap, a queue
bound, an optional memory cap, and a scheduling weight. A query is
routed to a LEAF group by the first matching selector (user/source
regexes), then admission walks the path root->leaf: it may RUN only
if every ancestor has concurrency and memory headroom; otherwise it
queues in its leaf (rejected when any ancestor's queue is full).
Releases dispatch the next queued query by weighted fairness among
eligible leaves (lowest running/weight ratio first — the analog of
the reference's weighted scheduling policy).

WITHIN a leaf, queueing is PER-USER weighted round-robin (reference:
the WEIGHTED_FAIR scheduling policy): each user gets their own FIFO,
and dequeue picks the user with the lowest dispatched/weight ratio —
a heavy user spraying hundreds of queries cannot starve a light
user's single dashboard refresh, whose queue position is always at
most one dispatch round away.

Load shedding is STRUCTURED: rejections raise QueryRejected with a
`kind` the failure taxonomy understands ("queue_full" for queue-bound
overflow, "rejected" for everything unservable), and queued entries
may carry a DEADLINE — an expired entry is dropped by the sweep (its
`on_expire` fires instead of `on_dispatch`), so a queue under
overload drains stale work instead of wedging on it. Every admission
decision counts into `ADMISSIONS[(decision, group)]` and every shed
into `SHEDS[(kind, group)]` (the reference's
`presto_tpu_admission_total` and `presto_tpu_admission_sheds_total`;
their /v1/metrics export and the `admission.enqueue` fault site come
with ROADMAP A14 and A10).

Memory accounting uses per-query declared reservations (the session's
query_memory_bytes): the coordinator has no live worker memory feed,
so groups bound the SUM of declared reservations — the same contract
as the reference's softMemoryLimit against cluster memory POOLS."""

from __future__ import annotations

import collections
import dataclasses
import itertools
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

#: (decision, group) -> admission decisions ("run", "queued", or a
#: rejection kind)
ADMISSIONS: "collections.Counter[tuple]" = collections.Counter()
#: (kind, group) -> sheds ("queue_full", "rejected", "queue_expired")
SHEDS: "collections.Counter[tuple]" = collections.Counter()


@dataclasses.dataclass
class GroupSpec:
    """Static definition of one group (reference:
    resource_groups.json's resourceGroups entries). `user_weights`
    biases the per-user round-robin within a LEAF (default weight 1:
    plain fair share)."""
    name: str
    hard_concurrency: int = 4
    max_queued: int = 100
    memory_limit_bytes: Optional[int] = None
    weight: int = 1
    subgroups: List["GroupSpec"] = dataclasses.field(
        default_factory=list)
    user_weights: Dict[str, int] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class Selector:
    """Routes a query to a leaf group by user/source regex (reference:
    StaticSelector.java). `group` is a dotted path under root."""
    group: str
    user: Optional[str] = None
    source: Optional[str] = None

    def matches(self, user: str, source: str) -> bool:
        if self.user is not None and not re.fullmatch(self.user, user):
            return False
        if self.source is not None \
                and not re.fullmatch(self.source, source):
            return False
        return True


@dataclasses.dataclass
class _QueuedEntry:
    user: str
    memory: int
    on_dispatch: Callable[[], None]
    #: monotonic instant after which the entry is DEAD (drop + fire
    #: on_expire instead of dispatching); None = waits forever
    deadline: Optional[float]
    on_expire: Optional[Callable[[], None]]
    seq: int
    enq_at: float


class _Group:
    def __init__(self, spec: GroupSpec, parent: Optional["_Group"]):
        self.spec = spec
        self.parent = parent
        self.path = spec.name if parent is None or parent.parent is None \
            else f"{parent.path}.{spec.name}"
        self.running = 0
        #: per-user FIFOs (leaves only) + the per-user dispatch counts
        #: the weighted round-robin dequeue balances on
        self.queues: "collections.OrderedDict[str, collections.deque]" \
            = collections.OrderedDict()
        self.queued_count = 0
        self.dispatched: Dict[str, int] = {}
        self.memory_reserved = 0
        self.children: Dict[str, _Group] = {}
        for sub in spec.subgroups:
            self.children[sub.name] = _Group(sub, self)

    # admission headroom must hold at EVERY level up to the root
    def _can_run(self, memory: int) -> bool:
        g = self
        while g is not None:
            if g.running >= g.spec.hard_concurrency:
                return False
            if g.spec.memory_limit_bytes is not None \
                    and g.memory_reserved + memory \
                    > g.spec.memory_limit_bytes:
                return False
            g = g.parent
        return True

    def _queue_full(self) -> bool:
        g = self
        while g is not None:
            if sum_queued(g) >= g.spec.max_queued:
                return True
            g = g.parent
        return False

    def _charge(self, memory: int, delta: int) -> None:
        g = self
        while g is not None:
            g.running += delta
            g.memory_reserved += delta * memory
            g = g.parent

    # -- per-user weighted round-robin (leaf-local) --------------------

    def _user_weight(self, user: str) -> int:
        return max(1, int(self.spec.user_weights.get(user, 1)))

    def _enqueue(self, entry: _QueuedEntry) -> None:
        q = self.queues.get(entry.user)
        if q is None or not q:
            # catch-up (reference: MultilevelSplitQueue's level-
            # minimum idea applied to users): a user JOINING the
            # queue must not replay history — without this, an
            # established user's lifetime dispatch count hands every
            # newcomer absolute priority until the counters converge
            # (starvation, inverted). Floor the newcomer's counter to
            # the lowest normalized share among currently-queued
            # users; fairness then applies to traffic from now on.
            ratios = [self.dispatched.get(u, 0) / self._user_weight(u)
                      for u, uq in self.queues.items() if uq]
            if ratios:
                floor = min(ratios) * self._user_weight(entry.user)
                if self.dispatched.get(entry.user, 0) < floor:
                    self.dispatched[entry.user] = floor
        self.queues.setdefault(entry.user,
                               collections.deque()).append(entry)
        self.queued_count += 1

    def _peek_next(self) -> Optional[_QueuedEntry]:
        """The entry the WRR dequeue would hand out next: among users
        with queued work, the lowest dispatched/weight ratio wins;
        ties break toward the OLDEST queue head so equal-share users
        drain in arrival order."""
        best = None
        best_key = None
        for user, q in self.queues.items():
            if not q:
                continue
            key = (self.dispatched.get(user, 0)
                   / self._user_weight(user), q[0].seq)
            if best_key is None or key < best_key:
                best_key = key
                best = q[0]
        return best

    def _pop_entry(self, entry: _QueuedEntry) -> None:
        q = self.queues.get(entry.user)
        q.remove(entry)
        if not q:
            del self.queues[entry.user]
        self.queued_count -= 1
        if self.queued_count == 0:
            # nobody waiting = fairness history is moot; dropping it
            # also bounds the per-user-name counter dict on
            # long-lived managers
            self.dispatched.clear()

    def _take_next(self) -> Optional[_QueuedEntry]:
        entry = self._peek_next()
        if entry is not None:
            # count before popping: the pop may drain the queue and
            # clear the counters — the increment must not resurrect
            # a single {user: 1} residue past that reset
            self.dispatched[entry.user] = \
                self.dispatched.get(entry.user, 0) + 1
            self._pop_entry(entry)
        return entry


def sum_queued(g: _Group) -> int:
    n = g.queued_count
    for c in g.children.values():
        n += sum_queued(c)
    return n


class QueryRejected(Exception):
    """Structured load shedding: `kind` is "queue_full" when a queue
    bound overflowed, "rejected" for everything unservable (no
    selector match, impossible reservation) — the query-failure
    taxonomy clients switch on."""

    def __init__(self, message: str, kind: str = "rejected",
                 group: str = "?"):
        super().__init__(message)
        self.kind = kind
        self.group = group


class ResourceGroupManager:
    """Thread-safe admission front end.

    submit() returns ("run", group_path) when admitted immediately, or
    ("queued", group_path) after parking `on_dispatch` to be called
    (on the releasing thread) when capacity frees; it raises
    QueryRejected when the leaf's (or an ancestor's) queue is full.
    finish() releases a slot and dispatches queued work by weighted
    fairness. Queued entries may carry a `deadline` (+ `on_expire`):
    expiry sweeps run at every submit/finish plus explicit
    expire_queued() calls, so stale work frees its queue position
    instead of blocking live clients behind it."""

    def __init__(self, root: GroupSpec,
                 selectors: Optional[List[Selector]] = None):
        self._root = _Group(root, None)
        self._selectors = selectors or []
        self._lock = threading.Lock()
        self._seq = itertools.count()

    # -- routing -----------------------------------------------------------

    def _leaf_for(self, user: str, source: str) -> _Group:
        g = None
        for sel in self._selectors:
            if sel.matches(user, source):
                g = self._root
                for part in sel.group.split("."):
                    child = g.children.get(part)
                    if child is None:
                        break
                    g = child
                break
        if g is None:
            if self._selectors:
                # the reference rejects no-match queries rather than
                # letting them consume some other team's quota
                raise QueryRejected(
                    f"no resource group selector matches user="
                    f"{user!r} source={source!r}", kind="rejected")
            g = self._root  # selector-less setups: the single group
        # queries must land on a LEAF: finish()'s dispatch scan only
        # walks leaves, so an interior queue would never drain. A
        # selector naming an interior (or misspelled) group descends
        # to its first leaf.
        while g.children:
            g = next(iter(g.children.values()))
        return g

    # -- protocol ----------------------------------------------------------

    def submit(self, user: str = "", source: str = "",
               memory_bytes: int = 0,
               on_dispatch: Optional[Callable[[], None]] = None,
               deadline: Optional[float] = None,
               on_expire: Optional[Callable[[], None]] = None
               ) -> Tuple[str, str]:
        expired: List[_QueuedEntry] = []
        try:
            with self._lock:
                self._sweep_expired_locked(expired)
                leaf = self._leaf_for(user, source)
                # a reservation no amount of draining can satisfy must
                # fail NOW — queued it would wedge its leaf's FIFO head
                # forever (the reference fails over-limit queries at
                # submission)
                g = leaf
                while g is not None:
                    if g.spec.memory_limit_bytes is not None \
                            and memory_bytes \
                            > g.spec.memory_limit_bytes:
                        raise QueryRejected(
                            f"query memory {memory_bytes} exceeds "
                            f"group {g.path}'s limit "
                            f"{g.spec.memory_limit_bytes}",
                            kind="rejected", group=g.path)
                    g = g.parent
                if leaf._can_run(memory_bytes):
                    leaf._charge(memory_bytes, +1)
                    ADMISSIONS["run", leaf.path] += 1
                    return "run", leaf.path
                if leaf._queue_full():
                    raise QueryRejected(
                        f"queue full for resource group {leaf.path}",
                        kind="queue_full", group=leaf.path)
                leaf._enqueue(_QueuedEntry(
                    user, memory_bytes,
                    on_dispatch or (lambda: None), deadline,
                    on_expire, next(self._seq), time.monotonic()))
                ADMISSIONS["queued", leaf.path] += 1
                return "queued", leaf.path
        except QueryRejected as e:
            ADMISSIONS[e.kind, e.group] += 1
            SHEDS[e.kind, e.group] += 1
            raise
        finally:
            self._fire_expired(expired)

    def finish(self, group_path: str, memory_bytes: int = 0) -> None:
        """Release one running slot of `group_path`, then dispatch as
        many queued queries (across ALL leaves) as now fit, weighted-
        fair: eligible leaves drain in ascending running/weight, and
        within a leaf users drain by per-user weighted round-robin."""
        dispatch: List[Callable[[], None]] = []
        expired: List[_QueuedEntry] = []
        with self._lock:
            g = self._find(group_path)
            g._charge(memory_bytes, -1)
            self._sweep_expired_locked(expired)
            self._dispatch_locked(dispatch)
        for cb in dispatch:
            cb()
        self._fire_expired(expired)

    def _dispatch_locked(self,
                         dispatch: List[Callable[[], None]]) -> None:
        while True:
            leaves = [x for x in self._leaves(self._root)
                      if x.queued_count]
            leaves.sort(key=lambda x: x.running
                        / max(x.spec.weight, 1))
            fired = False
            for leaf in leaves:
                entry = leaf._peek_next()
                if entry is not None and leaf._can_run(entry.memory):
                    leaf._take_next()
                    leaf._charge(entry.memory, +1)
                    dispatch.append(entry.on_dispatch)
                    fired = True
                    break
            if not fired:
                break

    # -- queue-wait deadlines ----------------------------------------------

    def _sweep_expired_locked(self,
                              out: List[_QueuedEntry]) -> None:
        now = time.monotonic()
        for leaf in self._leaves(self._root):
            if not leaf.queued_count:
                continue
            for user in list(leaf.queues):
                q = leaf.queues[user]
                for entry in [e for e in q
                              if e.deadline is not None
                              and now > e.deadline]:
                    leaf._pop_entry(entry)
                    out.append(entry)
                    SHEDS["queue_expired", leaf.path] += 1

    @staticmethod
    def _fire_expired(expired: List[_QueuedEntry]) -> None:
        for entry in expired:
            if entry.on_expire is not None:
                try:
                    entry.on_expire()
                except Exception:  # noqa: BLE001 — observer callback
                    pass

    def expire_queued(self) -> int:
        """Drop every queued entry past its deadline and fire its
        on_expire (outside the lock). Called by the coordinator's
        periodic pruner so expiry fires on an otherwise-idle manager
        too; returns the number dropped."""
        expired: List[_QueuedEntry] = []
        with self._lock:
            self._sweep_expired_locked(expired)
        self._fire_expired(expired)
        return len(expired)

    def cancel_queued(self, group_path: str, on_dispatch) -> bool:
        """Drop an abandoned queued entry (its callback identity) so it
        stops holding a queue position."""
        with self._lock:
            g = self._find(group_path)
            for q in g.queues.values():
                for entry in q:
                    if entry.on_dispatch is on_dispatch:
                        g._pop_entry(entry)
                        return True
        return False

    # -- observability -----------------------------------------------------

    def snapshot(self) -> List[dict]:
        """system.runtime-style rows: one per group."""
        out: List[dict] = []
        with self._lock:
            stack = [self._root]
            while stack:
                g = stack.pop()
                out.append({
                    "group": g.path,
                    "running": g.running,
                    "queued": sum_queued(g),
                    "queued_by_user": {u: len(q)
                                       for u, q in g.queues.items()
                                       if q},
                    "memory_reserved": g.memory_reserved,
                    "hard_concurrency": g.spec.hard_concurrency,
                    "max_queued": g.spec.max_queued,
                })
                stack.extend(g.children.values())
        return sorted(out, key=lambda r: r["group"])

    # -- internals ---------------------------------------------------------

    def _find(self, path: str) -> _Group:
        g = self._root
        if path == g.path:
            return g
        for part in path.split("."):
            child = g.children.get(part)
            if child is None:
                return g
            g = child
        return g

    def _leaves(self, g: Optional[_Group] = None) -> List[_Group]:
        if g is None:
            g = self._root
        if not g.children:
            return [g]
        out = []
        for c in g.children.values():
            out.extend(self._leaves(c))
        return out
