"""Lease-based leader election over the shared checkpoint directory
(DESIGN.md §Reliability), the port's copy of ``repro/runtime/lease.py``.

Several controllers co-supervising one fleet must agree on exactly one
supervisor, with takeover when the leader dies — and the takeover must
compose with checkpoint EPOCH FENCING so a deposed leader's workers
cannot corrupt the recovery line. The two mechanisms share ONE
monotonic counter, the checkpoint directory's ``FENCE`` file
(``repro_torch.checkpoint.advance_fence``):

  * a lease TERM is minted by advancing the fence (``term = fence+1``),
    so acquiring leadership immediately fences out every attempt epoch
    the previous leader ever granted — its in-flight workers find
    their commits rejected at the rename boundary before the new
    leader launches anything;
  * the leader mints each attempt's epoch the same way, so epochs and
    terms interleave on one total order and ``(epoch, step)`` snapshot
    ordering resolves the newest line unambiguously.

The lease itself is a crash-safe file (``LEASE``) in the checkpoint
directory:

    acquire   O_EXCL create — the filesystem arbitrates a dueling
              startup; exactly one creator wins, losers go standby
    renew     atomic replace (tmp + fsync + rename + dir fsync) with a
              fresh wall-clock stamp; BEFORE writing, the leader checks
              its OWN deadline — a leader that wakes from a long pause
              (GC, partition) past its ttl declares the lease lost
              without touching the file, so it can never clobber a
              usurper's lease (the standard check-your-own-clock
              fencing discipline)
    takeover  allowed only once ``stamp + ttl_s`` has passed (or the
              lease file is torn/corrupt — an unreadable lease cannot
              be renewed by anyone, so it is breakable); writes
              ``term = fence+1`` then verifies it won by re-reading
    release   unlink, only while still the owner

Election operations are serialized by an in-process lock (the same
discipline as ``advance_fence``'s ``_FENCE_LOCK``), so several
controllers in one process — the chaos-test topology — have NO
takeover race at all. Cross-process, the takeover's replace-then-
verify is a bounded window, not an arbiter: two standbys that both
saw the lease expired can both replace it and both re-read their own
write before seeing the other's, so both believe they lead for at
most one renewal interval (``renew_s``). That window is SAFE because
correctness never rests on the lease alone — it rests on fence
ordering: minting an attempt epoch goes through :meth:`mint_epoch`,
which re-verifies ownership against the lease file (under the lock)
in the same critical section that advances the fence, so the loser of
the window can never advance the fence past the winner's term; its
next renewal (or the mint itself) sees the foreign owner and stands
down, having launched nothing. A true multi-host deployment over a
store without POSIX O_EXCL/rename semantics needs a real CAS here —
see ROADMAP (cross-host fence minting).

Wall-clock expiry is the single-host simulation of a heartbeat
session; the injectable ``clock`` keeps chaos tests deterministic.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable

from repro_torch.checkpoint import advance_fence, read_fence
from repro_torch.checkpoint.checkpointer import _fsync_path

LEASE_FILE = "LEASE"

# Serializes acquire/renew/mint/release across the controllers of one
# process: in-process (the chaos-test topology) the takeover and the
# leader's epoch minting cannot interleave at all. Cross-process the
# remaining replace-then-verify window is bounded and documented in
# the module docstring. Nests over the checkpointer's _FENCE_LOCK
# (mint_epoch -> advance_fence); nothing takes them in reverse order.
_ELECTION_LOCK = threading.Lock()


class LeaseLost(RuntimeError):
    """The caller no longer holds the lease: its own deadline passed
    (missed renewals — GC pause, partition) or another controller's
    term is on disk. The holder must stop supervising immediately; its
    workers' commits are already fenced out by the usurper's term."""


@dataclasses.dataclass(frozen=True)
class LeasePolicy:
    """Election knobs. ``ttl_s`` is the takeover latency floor: a dead
    leader is only safe to replace once its last renewal has aged out.
    Renewals should land several times per ttl (default ttl/3) so one
    slow poll does not read as death."""

    ttl_s: float = 2.0
    renew_every_s: float | None = None   # default ttl_s / 3
    poll_s: float = 0.05                 # standby watch interval
    standby_timeout_s: float | None = None  # give up standing by (None
    #                                       = stand by forever)

    def __post_init__(self):
        assert self.ttl_s > 0.0, self.ttl_s
        assert (self.renew_every_s is None
                or 0.0 < self.renew_every_s < self.ttl_s)
        assert self.poll_s > 0.0, self.poll_s

    @property
    def renew_s(self) -> float:
        return (self.renew_every_s if self.renew_every_s is not None
                else self.ttl_s / 3.0)


@dataclasses.dataclass(frozen=True)
class LeaseState:
    term: int
    owner: str
    stamp: float                 # wall-clock seconds at grant/renewal
    ttl_s: float

    def expired(self, now: float | None = None) -> bool:
        return (time.time() if now is None else now) \
            > self.stamp + self.ttl_s


class LeaseManager:
    """One controller's handle on the election. Not thread-safe: a
    controller renews from its single supervision loop."""

    def __init__(self, directory: str, owner: str, *,
                 policy: LeasePolicy | None = None,
                 clock: Callable[[], float] = time.time):
        self.dir = str(directory)
        self.owner = str(owner)
        self.policy = policy or LeasePolicy()
        self.clock = clock
        self.path = os.path.join(self.dir, LEASE_FILE)
        self.state: LeaseState | None = None   # held lease, if any

    # ------------------------------------------------------------ file io
    def read(self) -> LeaseState | None:
        """The lease on disk, or None if absent OR unreadable. A torn
        lease write (injected chaos; a crash mid-write from a
        fsync-less older version) parses as None — no owner could renew
        it either, so takeover treats it as immediately breakable."""
        try:
            with open(self.path) as f:
                d = json.load(f)
            return LeaseState(term=int(d["term"]), owner=str(d["owner"]),
                              stamp=float(d["stamp"]),
                              ttl_s=float(d["ttl_s"]))
        except FileNotFoundError:
            return None
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            return None

    def _payload(self, st: LeaseState) -> str:
        return json.dumps({"term": st.term, "owner": st.owner,
                           "stamp": st.stamp, "ttl_s": st.ttl_s})

    def _write_excl(self, st: LeaseState) -> bool:
        """O_EXCL create — the dueling-startup arbiter. Returns False
        if another controller created the lease first."""
        try:
            fd = os.open(self.path,
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        try:
            os.write(fd, self._payload(st).encode())
            os.fsync(fd)
        finally:
            os.close(fd)
        _fsync_path(self.dir)
        return True

    def _write_replace(self, st: LeaseState) -> None:
        tmp = f"{self.path}.tmp.{self.owner}"
        with open(tmp, "w") as f:
            f.write(self._payload(st))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        _fsync_path(self.dir)

    # ----------------------------------------------------------- election
    def _mint_term(self, *extra: int) -> int:
        term = max(read_fence(self.dir), *extra, 0) + 1
        advance_fence(self.dir, term, self.owner)
        return term

    def try_acquire(self) -> LeaseState | None:
        """One election round. Returns the held lease when this
        controller is (now) the leader, None when it should stand by.
        Acquiring ADVANCES THE FENCE to the new term first, so by the
        time leadership is visible every write the previous leader's
        workers could attempt is already doomed at the commit boundary.

        In-process, the election lock makes the expiry takeover
        atomic. Cross-process, two standbys racing an expired lease
        can BOTH pass the replace-then-verify for up to one renewal
        interval (the bounded dual-leader window, module docstring);
        the fence ordering enforced by :meth:`mint_epoch` keeps that
        window harmless — the loser launches nothing and stands down
        at its next renewal.
        """
        with _ELECTION_LOCK:
            return self._try_acquire_locked()

    def _try_acquire_locked(self) -> LeaseState | None:
        os.makedirs(self.dir, exist_ok=True)
        cur = self.read()
        if cur is None and not os.path.exists(self.path):
            # No lease: contend via O_EXCL — filesystem picks one winner.
            st = LeaseState(term=self._mint_term(), owner=self.owner,
                            stamp=self.clock(), ttl_s=self.policy.ttl_s)
            if self._write_excl(st):
                self.state = st
                return st
            return None
        if cur is not None and cur.owner == self.owner \
                and not cur.expired(self.clock()):
            self.state = cur                      # already the leader
            return cur
        if cur is not None and not cur.expired(self.clock()):
            return None                           # healthy foreign leader
        # Expired or torn: break it. Mint term past both the fence and
        # the dead lease's term, replace atomically, then verify the
        # takeover stuck (another standby may have raced this one; the
        # last rename wins and the loser sees a foreign owner).
        st = LeaseState(
            term=self._mint_term(cur.term if cur is not None else 0),
            owner=self.owner, stamp=self.clock(),
            ttl_s=self.policy.ttl_s)
        self._write_replace(st)
        back = self.read()
        if back is not None and back.owner == self.owner \
                and back.term == st.term:
            self.state = st
            return st
        return None

    def renew(self) -> LeaseState:
        """Refresh the stamp. Raises :class:`LeaseLost` if this
        controller's own deadline has already passed (it must not
        write — a usurper may hold the lease) or if the file shows a
        foreign owner/term. May raise ``OSError`` from the lease write
        itself (ENOSPC, EIO) — the caller should treat that as a
        missed heartbeat, not as loss: the stamp is unchanged, so the
        next renewal either succeeds or ages out via the own-deadline
        check."""
        with _ELECTION_LOCK:
            return self._renew_locked()

    def mint_epoch(self) -> int:
        """Verify leadership and advance the shared fence to a fresh
        attempt epoch — ATOMICALLY, in one critical section, so a
        leader whose lease silently expired (a drain window, a
        relaunch backoff) can never advance the fence past a usurper's
        term: the renewal inside the lock sees the foreign owner (or
        this controller's own missed deadline) and raises
        :class:`LeaseLost` BEFORE the fence is touched. This is the
        renew-before-mint discipline the split-brain proof rests on;
        controllers must mint attempt epochs through here, never via a
        bare ``advance_fence``."""
        with _ELECTION_LOCK:
            try:
                st = self._renew_locked()
            except OSError:
                # The stamp WRITE failed (ENOSPC, EIO) — but only
                # after ownership was verified (read errors parse as a
                # foreign lease and raise LeaseLost above): a missed
                # heartbeat, not loss. The mint may proceed; the stamp
                # is refreshed by the supervision loop's next renewal.
                st = self.state
            epoch = max(read_fence(self.dir), st.term) + 1
            advance_fence(self.dir, epoch, self.owner)
            return epoch

    def _renew_locked(self) -> LeaseState:
        if self.state is None:
            raise LeaseLost(f"{self.owner} holds no lease on {self.dir}")
        now = self.clock()
        if self.state.expired(now):
            held = self.state
            self.state = None
            raise LeaseLost(
                f"{self.owner} missed its own lease deadline on "
                f"{self.dir} (term {held.term}: last renewal "
                f"{now - held.stamp:.3f}s ago > ttl {held.ttl_s}s) — "
                "standing down without touching the lease file")
        cur = self.read()
        if cur is None or cur.owner != self.owner \
                or cur.term != self.state.term:
            self.state = None
            raise LeaseLost(
                f"{self.owner} found a foreign lease on {self.dir}: "
                f"{cur} — superseded")
        st = dataclasses.replace(cur, stamp=now)
        self._write_replace(st)
        self.state = st
        return st

    def release(self) -> None:
        """Drop leadership cleanly (normal completion): removes the
        lease file so a standby can take over without waiting out the
        ttl. No-op when not the owner."""
        if self.state is None:
            return
        with _ELECTION_LOCK:
            self._release_locked()

    def _release_locked(self) -> None:
        cur = self.read()
        if cur is not None and cur.owner == self.owner \
                and cur.term == self.state.term:
            try:
                os.remove(self.path)
                _fsync_path(self.dir)
            except OSError:
                pass
        self.state = None
