"""Burn-rate fleet autoscaler (the JAX package's
``streaming/autoscale.py``): grow and shrink an ``EngineFleetRouter`` on
SLO burn rate and fleet utilization, with hysteresis.

Each tick reads two signals:

- **burn rate**: the :class:`~..observability.slo.SLOTracker`'s
  short-window error-budget burn (the long window keeps one blip from
  flapping capacity);
- **utilization**: fleet-wide load / decode-slot capacity from the
  router's live replica gauges: 1.0 means every cache slot is busy,
  above 1.0 a queue is building, so a saturating fleet grows before
  requests start missing.

A signal must persist for ``up_consecutive`` / ``down_consecutive``
ticks, each action starts a ``cooldown_s`` window, and the replica count
stays in [``min_replicas``, ``max_replicas``]. Scale-up calls
``router.add_replica()`` (a grown replica shares the fleet's decoder, so
it builds nothing). Scale-down calls ``router.retire_replica()``, which
rides the preemption drain (admission closes, the in-flight block
retires, the harvested requests re-dispatch under the FleetLedger
fence): zero lost, zero duplicated. The victim is the least-loaded live
replica.

``evaluate_once(signals=...)`` is the pure decision function (tests
inject signals; the background loop feeds live ones). Every action lands
in :attr:`history` and on the flight recorder. ``role=`` restricts a
controller to one pool of a ``streaming.disagg.PhaseRouter``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..observability.flightrec import default_flight_recorder
from ..observability.metrics import default_registry

#: health states a replica may count toward capacity (import-light copy
#: of streaming/fleet.py's vocabulary)
_DEAD = "DEAD"
#: CORRUPT replicas (the integrity quarantine) are equally non-live: they
#: never count toward capacity and are never picked as descale victims
_CORRUPT = "CORRUPT"


class BurnRateAutoscaler:
    """Grow/shrink a fleet on SLO burn rate + utilization, with
    hysteresis. ``start()`` spins the control loop; ``stop()`` halts it.

    Scale UP when, for ``up_consecutive`` ticks, the short-window burn
    rate exceeds ``scale_up_burn`` OR utilization exceeds
    ``saturation_high``. Scale DOWN when, for ``down_consecutive``
    ticks, BOTH burn windows sit under ``scale_down_burn`` AND
    utilization sits under ``saturation_low``. ``cooldown_s`` gates
    consecutive actions (capacity changes take time to show up in the
    windows — acting again before they do double-corrects)."""

    def __init__(self, router, *, tracker=None,
                 min_replicas: int = 1, max_replicas: int = 4,
                 scale_up_burn: float = 2.0,
                 scale_down_burn: float = 0.5,
                 saturation_high: float = 1.5,
                 saturation_low: float = 0.5,
                 up_consecutive: int = 2, down_consecutive: int = 4,
                 cooldown_s: float = 2.0, interval: float = 0.25,
                 drain_budget: float = 10.0,
                 registry=None, flight_recorder=None,
                 role: Optional[str] = None):
        if not 1 <= int(min_replicas) <= int(max_replicas):
            raise ValueError(f"need 1 <= min_replicas <= max_replicas, "
                             f"got {min_replicas}..{max_replicas}")
        self.router = router
        # per-role mode (disagg tier): when ``role`` is set,
        # every signal, clamp, and action restricts to that pool — burn
        # from the role's replicas (router.role_burn_rate), utilization
        # from the role's slots, scale-up adds a same-role worker, and
        # victim selection never touches the other phase. Two of these
        # controllers (streaming.disagg.PhaseAutoscaler) scale prefill
        # and decode capacity independently on their own burn rates.
        self.role = role
        if role is not None and (
                not hasattr(router, "role_burn_rate") or
                not hasattr(router, "replica_role")):
            raise ValueError("role= needs a role-aware router "
                             "(streaming.disagg.PhaseRouter)")
        self.tracker = tracker if tracker is not None \
            else router._slo_tracker
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_burn = float(scale_up_burn)
        self.scale_down_burn = float(scale_down_burn)
        self.saturation_high = float(saturation_high)
        self.saturation_low = float(saturation_low)
        self.up_consecutive = int(up_consecutive)
        self.down_consecutive = int(down_consecutive)
        self.cooldown_s = float(cooldown_s)
        self.interval = float(interval)
        self.drain_budget = float(drain_budget)
        self._flightrec = flight_recorder if flight_recorder is not None \
            else default_flight_recorder()
        self._lock = threading.Lock()
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_t: Optional[float] = None
        self.history: List[dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = registry if registry is not None else default_registry()
        self._m_actions = reg.counter(
            "autoscale_actions_total",
            "autoscaler capacity changes, by direction", ("direction",))
        g = reg.gauge("autoscale_signal",
                      "autoscaler input signals at the last tick",
                      ("signal",))
        self._g_burn = g.labels("burn_short")
        self._g_util = g.labels("utilization")

    # ------------------------------------------------------------ signals
    def _role_rids(self):
        """The rids this controller governs (None = whole fleet)."""
        if self.role is None:
            return None
        return set(self.router.role_ids(self.role))

    def signals(self) -> Dict[str, float]:
        """Live inputs: short/long burn rate, utilization, and the
        non-DEAD replica count — fleet-wide, or restricted to this
        controller's role pool."""
        loads = self.router.replica_loads()
        rids = self._role_rids()
        live = sum(1 for rid, (_, _, st) in loads.items()
                   if st not in (_DEAD, _CORRUPT) and
                   (rids is None or rid in rids))
        if self.role is None:
            util = self.router.utilization()
            burn_s = self.tracker.burn_rate(self.tracker.short_window)
            burn_l = self.tracker.burn_rate(self.tracker.long_window)
        else:
            util = self.router.utilization(role=self.role)
            burn_s = self.router.role_burn_rate(
                self.role, self.tracker.short_window)
            burn_l = self.router.role_burn_rate(
                self.role, self.tracker.long_window)
        return {
            "burn_short": burn_s,
            "burn_long": burn_l,
            "utilization": util,
            "live_replicas": live,
        }

    # ----------------------------------------------------------- decision
    def evaluate_once(self, signals: Optional[Dict[str, float]] = None,
                      now: Optional[float] = None) -> Optional[str]:
        """One control tick: fold the signals into the hysteresis state
        and return the action taken ("up", "down", or None). Pure given
        ``signals`` — tests inject them; the live loop omits them."""
        sig = self.signals() if signals is None else signals
        t = time.monotonic() if now is None else float(now)
        self._g_burn.set(float(sig["burn_short"]))
        self._g_util.set(float(sig["utilization"]))
        with self._lock:
            want_up = (sig["burn_short"] > self.scale_up_burn or
                       sig["utilization"] > self.saturation_high)
            want_down = (sig["burn_short"] <= self.scale_down_burn and
                         sig["burn_long"] <= self.scale_down_burn and
                         sig["utilization"] < self.saturation_low)
            self._up_streak = self._up_streak + 1 if want_up else 0
            self._down_streak = self._down_streak + 1 if want_down else 0
            cooling = (self._last_action_t is not None and
                       t - self._last_action_t < self.cooldown_s)
            live = int(sig["live_replicas"])
            action = None
            if not cooling:
                if self._up_streak >= self.up_consecutive and \
                        live < self.max_replicas:
                    action = "up"
                elif self._down_streak >= self.down_consecutive and \
                        live > self.min_replicas:
                    action = "down"
        if action is None:
            return None
        done = self._act(action, sig)
        if done is not None:
            # cooldown + streak reset only on a SUCCESSFUL capacity
            # change: a failed add/retire must not suppress the
            # controller while the fleet is still the wrong size
            with self._lock:
                self._last_action_t = t
                self._up_streak = 0
                self._down_streak = 0
        return done

    def _act(self, action: str, sig: Dict[str, float]) -> Optional[str]:
        entry = {"t": time.monotonic(), "action": action,
                 "signals": {k: round(float(v), 6)
                             for k, v in sig.items()}}
        try:
            if action == "up":
                entry["replica"] = self.router.add_replica() \
                    if self.role is None \
                    else self.router.add_replica(role=self.role)
                if self.role is not None:
                    entry["role"] = self.role
            else:
                victim = self._pick_victim()
                if victim is None:
                    return None          # nothing retirable this tick
                entry["replica"] = victim
                entry["drain"] = self.router.retire_replica(
                    victim, budget=self.drain_budget, reason="autoscale")
        except Exception as exc:   # noqa: BLE001 — a failed action must
            entry["error"] = f"{type(exc).__name__}: {exc}"   # not kill
            action = None                                     # the loop
        with self._lock:
            self.history.append(entry)
        if action is not None:
            self._m_actions.labels(action).inc()
        self._flightrec.record("autoscale", **{
            k: v for k, v in entry.items()
            if isinstance(v, (str, int, float))})
        return action

    def _pick_victim(self) -> Optional[str]:
        """Least-loaded live replica (its drain moves the fewest
        requests); highest id breaks ties so repeated descales retire
        the replicas scale-up added, newest first."""
        loads = self.router.replica_loads()
        rids = self._role_rids()
        live = [(ld, rid) for rid, (ld, _, st) in loads.items()
                if st not in (_DEAD, _CORRUPT) and
                (rids is None or rid in rids)]
        if len(live) <= self.min_replicas:
            return None
        live.sort(key=lambda p: (p[0], -int(p[1].lstrip("rpd") or 0)
                                 if p[1].lstrip("rpd").isdigit() else 0))
        return live[0][1]

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "BurnRateAutoscaler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="autoscaler")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.evaluate_once()
            except Exception:   # noqa: BLE001 — a transient read error
                continue        # (mid-retire races) skips one tick

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=self.drain_budget + 35.0)
        self._thread = None

    def stats(self) -> dict:
        with self._lock:
            ups = sum(1 for e in self.history
                      if e.get("action") == "up" and "error" not in e)
            downs = sum(1 for e in self.history
                        if e.get("action") == "down" and "error" not in e)
            return {"scale_ups": ups, "scale_downs": downs,
                    "actions": len(self.history),
                    "up_streak": self._up_streak,
                    "down_streak": self._down_streak}
