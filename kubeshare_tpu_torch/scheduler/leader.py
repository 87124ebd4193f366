"""Leader election for the scheduler.

The port's own copy of kubeshare_tpu/scheduler/leader.py (the port imports nothing
of the JAX package).

The reference inherited HA from kube-scheduler's lease machinery
(ref deploy/scheduler.yaml:74-112 runs it as a kube-scheduler profile);
this standalone scheduler carries its own: a named Lease object that one
instance holds and renews, arbitrated by the cluster backend
(`ClusterAPI.lease_tryhold` — coordination.k8s.io/v1 on K8sCluster, an
in-memory lease on FakeCluster).  Non-leaders idle; a leader that cannot
renew steps down once its lease duration passes, upholding the lease
invariant (at most one instance binds at any time, assuming bounded
clock skew — the same contract kube-scheduler's elector gives).
"""

from __future__ import annotations

from typing import Optional

from ..cluster.api import Clock, ClusterAPI
from ..utils.logger import get_logger


class LeaderElector:
    """Cooperative lease-based election: call :meth:`is_leader` once per
    scheduling cycle; it acquires/renews the lease and reports whether
    this instance leads right now.

    Degrades gracefully: a backend without lease support
    (NotImplementedError) logs once and runs single-instance (always
    leader).  A transient apiserver error keeps the PREVIOUS answer only
    until the RENEW DEADLINE (2/3 of the lease duration) since the last
    successful renew — stepping down strictly BEFORE the lease becomes
    stealable by a peer, so a leader that lost the apiserver and a peer
    that steals the expired lease can never schedule concurrently (the
    same renewDeadline < leaseDuration margin kube-scheduler keeps).

    Lease traffic is paced, not per-call: a leader renews every
    lease_duration/3, a standby re-checks every ~lease_duration/7.5
    (~2 s at the 15 s default — kube-scheduler's retry period); calls in
    between return the cached answer, so a busy scheduling loop costs no
    extra apiserver round-trips.
    """

    def __init__(
        self,
        cluster: ClusterAPI,
        identity: str,
        lease_name: str = "kubeshare-scheduler",
        lease_duration_s: float = 15.0,
        clock: Optional[Clock] = None,
    ) -> None:
        self.cluster = cluster
        self.identity = identity
        self.lease_name = lease_name
        self.lease_duration_s = lease_duration_s
        self.renew_deadline_s = lease_duration_s * (2.0 / 3.0)
        self.renew_period_s = lease_duration_s / 3.0
        self.retry_period_s = lease_duration_s / 7.5
        self.clock = clock or Clock()
        self.log = get_logger("kubeshare-scheduler")
        self._was_leader = False
        self._last_renew = float("-inf")
        self._next_attempt = float("-inf")
        self._degraded = False
        self._error_logged = False
        self._first_error_at: Optional[float] = None

    def is_leader(self) -> bool:
        now = self.clock.now()
        if self._degraded:
            return True
        if now < self._next_attempt:
            # cached answer between renew ticks; a cached "leader" still
            # steps down at the renew deadline even without an attempt
            if self._was_leader and (
                    now - self._last_renew >= self.renew_deadline_s):
                self._was_leader = False
            return self._was_leader
        try:
            holder = self.cluster.lease_tryhold(
                self.lease_name, self.identity, self.lease_duration_s, now
            )
        except NotImplementedError:
            self.log.warning(
                "cluster backend has no lease support; leader election "
                "degrades to single-instance mode"
            )
            self._degraded = True
            return True
        except Exception as e:
            # apiserver hiccup: retry soon; hold the leader answer only
            # inside the renew deadline (see class docstring)
            self._next_attempt = now + self.retry_period_s
            if self._first_error_at is None:
                self._first_error_at = now
            if not self._error_logged:
                self.log.warning("lease attempt failed (will retry): %s", e)
                self._error_logged = True
            if now - self._first_error_at > 4 * self.lease_duration_s:
                # not a blip: a persistently failing election (RBAC denies
                # leases, wrong namespace, ...) must not degrade to a
                # scheduler that silently never schedules — fail loudly,
                # like kube-scheduler exiting when its elector dies
                raise RuntimeError(
                    f"leader election failing for over "
                    f"{4 * self.lease_duration_s:.0f}s "
                    f"(lease {self.lease_name!r}): {e}"
                ) from e
            if (self._was_leader
                    and now - self._last_renew < self.renew_deadline_s):
                return True
            if self._was_leader:
                self.log.warning(
                    "lease renew failing past the renew deadline; "
                    "stepping down: %s", e)
                self._was_leader = False
            return False
        self._error_logged = False
        self._first_error_at = None
        leading = holder == self.identity
        if leading:
            self._last_renew = now
            self._next_attempt = now + self.renew_period_s
        else:
            self._next_attempt = now + self.retry_period_s
        if leading and not self._was_leader:
            self.log.info("acquired leadership (lease %s as %s)",
                          self.lease_name, self.identity)
        elif self._was_leader and not leading:
            self.log.warning("lost leadership to %s", holder)
        self._was_leader = leading
        return leading
