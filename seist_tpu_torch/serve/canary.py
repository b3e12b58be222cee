"""Canary rollout + shadow mode for the front-tier router — the
traffic-shifting half of the live-model flywheel (the replica-side half
is serve/pool.ModelPool.reload). The port's copy of
``seist_tpu/serve/canary.py``: the same names, verdicts, counters and
report lines.

A new model version never takes the fleet by fiat (the t5x operational
model, arXiv:2203.17189): it earns traffic incrementally —

* **Canary** (:class:`CanaryController`): ``k%`` of first attempts route
  to the replicas serving the CANDIDATE version (discovered from each
  replica's ``/healthz/ready`` ``versions`` payload by the router's
  prober); everything else — including every retry — stays on the
  incumbent cohort, so a sick candidate can make a request slower, never
  make it fail. The controller compares the two cohorts' error rates and
  latency EWMAs online; a candidate whose delta exceeds the budget is
  **auto-rolled-back** — drained to 0% instantly, the verdict kept in
  ``status()``, counted on the bus (``router_canary_rollback``) and
  flagged on the triggering request's trace (``canary_rollback``, tail-
  retained).
* **Shadow** (:class:`ShadowMirror`): a deterministic sample of /predict
  requests is MIRRORED to the candidate cohort after the incumbent
  answered (the client only ever sees the incumbent's response); the two
  decoded responses are diffed at DECISION level (:func:`decision_diff` —
  the load-time parity gates' comparisons applied online to the wire format:
  pick positions, argmax classes, scaled regression values) and every
  verdict appended to a JSONL report. Shadow is how a candidate earns
  its first percent: disagreement shows up in the report before any
  client ever saw the new weights.

Stdlib only — this module runs in the router/supervisor process, which
imports neither torch nor numpy (serve/router.py's front-tier contract).
"""

from __future__ import annotations

import json
import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

from seist_tpu_torch.utils.logger import logger

#: Decision-level tolerances for online response diffs — the wire-format
#: analog of serve/aot._PARITY_TOL's "decision, not bits" philosophy.
PICK_TOL_SAMPLES = 10  # a pick moved further than this is a decision flip
VALUE_REL_TOL = 0.05  # regression values compare relative to magnitude
VALUE_ABS_TOL = 0.05  # ...with an absolute floor near zero


def serves_version(
    versions: Optional[Mapping[str, Any]],
    version: int,
    model: Optional[str] = None,
) -> bool:
    """Does a replica's probed ``{model: version}`` map serve
    ``version`` — for ``model`` when scoped, for any model otherwise?
    The ONE cohort-membership test behind canary routing, shadow
    targeting and the router's pick predicate."""
    if not versions:
        return False
    try:
        if model:
            served = versions.get(model)
            return served is not None and int(served) == int(version)
        return any(int(v) == int(version) for v in versions.values())
    except (TypeError, ValueError, AttributeError):
        return False


@dataclass(frozen=True)
class CanaryBudget:
    """Auto-rollback budget: how much worse the candidate cohort may run
    before it is drained. Deltas are candidate-minus-incumbent, so a
    fleet-wide slowdown (overload, noisy box) does not scapegoat the
    canary."""

    #: rollback when cand_error_rate - incumbent_error_rate exceeds this
    max_error_delta: float = 0.10
    #: rollback when the candidate's latency EWMA exceeds the
    #: incumbent's by more than this (ms); inf = latency never trips
    max_latency_delta_ms: float = float("inf")
    #: candidate requests observed before any verdict (small-sample
    #: noise must not kill a healthy canary)
    min_requests: int = 20


@dataclass
class _CohortStats:
    requests: int = 0
    errors: int = 0
    latency_ewma_ms: float = 0.0

    def observe(self, error: bool, latency_ms: Optional[float]) -> None:
        self.requests += 1
        if error:
            self.errors += 1
        if latency_ms is not None:
            self.latency_ewma_ms = (
                latency_ms
                if self.latency_ewma_ms == 0.0
                else 0.8 * self.latency_ewma_ms + 0.2 * latency_ms
            )

    @property
    def error_rate(self) -> float:
        return self.errors / self.requests if self.requests else 0.0

    def snapshot(self) -> Dict[str, Any]:
        return {
            "requests": self.requests,
            "errors": self.errors,
            "error_rate": round(self.error_rate, 4),
            "latency_ewma_ms": round(self.latency_ewma_ms, 3),
        }


class CanaryController:
    """Weighted version-aware routing + cohort-delta auto-rollback.

    States: ``inactive`` (no canary; routing untouched) -> ``active``
    (``percent``% of first attempts go candidate) -> ``rolled_back``
    (candidate drained to 0%; incumbent serves 100% until an operator
    clears or restarts the canary). Thread-safe: the router's handler
    threads route and observe concurrently."""

    def __init__(self):
        self._lock = threading.Lock()
        self._state = "inactive"
        self.version: Optional[int] = None
        self.model: Optional[str] = None
        self.percent = 0.0
        self.budget = CanaryBudget()
        self._n = 0  # weighted round-robin counter
        self._cohorts = {
            "candidate": _CohortStats(), "incumbent": _CohortStats()
        }
        self._rollback_reason = ""

    # ------------------------------------------------------------- control
    def start(
        self,
        version: int,
        percent: float,
        budget: Optional[CanaryBudget] = None,
        model: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Start (or re-weight) a canary for ``version`` at ``percent``%
        of first attempts. Restarting resets the cohort stats — a new
        observation window, not a continuation of a rolled-back one.

        ``model`` scopes the cohort test to ONE entry of a multi-model
        pool: without it a bare version number would match any model's
        version in the replicas' ``versions`` maps, and a fleet whose
        model A already runs at version 5 could never canary model B's
        version 5 (the incumbent cohort would be empty and the healthy
        canary would be rolled back on phantom deltas)."""
        version = int(version)
        percent = float(percent)
        if not (0.0 < percent <= 100.0):
            raise ValueError(
                f"percent must be in (0, 100], got {percent} "
                "(use stop() / percent=0 to clear)"
            )
        if not math.isfinite(percent):
            raise ValueError("percent must be finite")
        with self._lock:
            self._state = "active"
            self.version = version
            self.model = model or None
            self.percent = percent
            self.budget = budget or CanaryBudget()
            self._n = 0
            self._cohorts = {
                "candidate": _CohortStats(), "incumbent": _CohortStats()
            }
            self._rollback_reason = ""
        logger.info(
            f"[router] canary started: "
            + (f"model {model} " if model else "")
            + f"version {version} at {percent:g}%"
        )
        return self.status()

    def stop(self) -> Dict[str, Any]:
        """Clear the canary entirely (back to version-blind routing)."""
        with self._lock:
            self._state = "inactive"
            self.version = None
            self.model = None
            self.percent = 0.0
            self._rollback_reason = ""
        return self.status()

    # ------------------------------------------------------------- routing
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def routing_cohort(self, first_attempt: bool) -> Optional[str]:
        """Which cohort this attempt must route to: ``None`` = no canary
        (version-blind pick). Retries NEVER go candidate — a failed
        candidate attempt retries on the incumbent, so canary failures
        cost latency, not availability. In ``rolled_back`` the candidate
        cohort gets exactly 0%."""
        with self._lock:
            if self._state == "inactive":
                return None
            if self._state == "rolled_back" or not first_attempt:
                return "incumbent"
            # Deterministic weighted round-robin: candidate exactly when
            # floor(n*p/100) increments — k% without RNG, test-exact.
            self._n += 1
            take = (self._n * self.percent) // 100.0 > (
                (self._n - 1) * self.percent
            ) // 100.0
            return "candidate" if take else "incumbent"

    def cohort_of(self, versions: Mapping[str, Any]) -> str:
        """Cohort of a replica given its served ``{model: version}``
        (from the prober): candidate iff it serves the canary version —
        for the canary's model when one was scoped, for any model
        otherwise (single-model fleets)."""
        with self._lock:
            version, model = self.version, self.model
        if version is None:
            return "incumbent"
        return (
            "candidate"
            if serves_version(versions, version, model)
            else "incumbent"
        )

    # ----------------------------------------------------------- verdicts
    def observe(
        self, cohort: str, error: bool, latency_ms: Optional[float] = None
    ) -> Optional[str]:
        """Record one settled attempt outcome for ``cohort`` and evaluate
        the rollback budget. Returns the rollback reason EXACTLY ONCE —
        on the observation that tripped it — so the caller can flag that
        request's trace and count the event without dedup bookkeeping."""
        with self._lock:
            if self._state != "active" or cohort not in self._cohorts:
                return None
            self._cohorts[cohort].observe(error, latency_ms)
            cand = self._cohorts["candidate"]
            inc = self._cohorts["incumbent"]
            if cand.requests < self.budget.min_requests:
                return None
            reason = ""
            err_delta = cand.error_rate - inc.error_rate
            if err_delta > self.budget.max_error_delta:
                reason = (
                    f"error-rate delta {err_delta:.3f} > budget "
                    f"{self.budget.max_error_delta:.3f} (candidate "
                    f"{cand.errors}/{cand.requests}, incumbent "
                    f"{inc.errors}/{inc.requests})"
                )
            elif (
                math.isfinite(self.budget.max_latency_delta_ms)
                and cand.latency_ewma_ms > 0.0
                and inc.latency_ewma_ms > 0.0
                and cand.latency_ewma_ms - inc.latency_ewma_ms
                > self.budget.max_latency_delta_ms
            ):
                reason = (
                    f"latency delta "
                    f"{cand.latency_ewma_ms - inc.latency_ewma_ms:.1f} ms "
                    f"> budget {self.budget.max_latency_delta_ms:.1f} ms "
                    f"(candidate EWMA {cand.latency_ewma_ms:.1f}, "
                    f"incumbent {inc.latency_ewma_ms:.1f})"
                )
            if not reason:
                return None
            self._state = "rolled_back"
            self.percent = 0.0
            self._rollback_reason = (
                f"version {self.version} rolled back: {reason}"
            )
            return self._rollback_reason

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "version": self.version,
                "model": self.model,
                "percent": self.percent,
                "budget": {
                    "max_error_delta": self.budget.max_error_delta,
                    "max_latency_delta_ms": self.budget.max_latency_delta_ms,
                    "min_requests": self.budget.min_requests,
                },
                "cohorts": {
                    k: v.snapshot() for k, v in self._cohorts.items()
                },
                "rollback_reason": self._rollback_reason,
            }


class ShadowMirror:
    """Mirror a sample of /predict traffic to the candidate cohort and
    diff the decisions offline — the client always gets the incumbent's
    answer. Mirrors are breaker-neutral by design (shadow is observation;
    a sick candidate must surface in the REPORT, not destabilize the
    routing state the incumbent depends on)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active = False
        self.version: Optional[int] = None
        self.model: Optional[str] = None
        self.sample = 0.0
        self.report_path = ""
        self._counts = {
            "mirrored": 0, "match": 0, "mismatch": 0,
            "mirror_errors": 0, "no_candidate": 0, "skipped_busy": 0,
        }

    def start(
        self,
        version: int,
        sample: float,
        report_path: str = "",
        model: Optional[str] = None,
    ) -> Dict[str, Any]:
        sample = float(sample)
        if not (0.0 < sample <= 1.0):
            raise ValueError(
                f"sample must be in (0, 1], got {sample} "
                "(use stop() / sample=0 to clear)"
            )
        with self._lock:
            self._active = True
            self.version = int(version)
            self.model = model or None
            self.sample = sample
            self.report_path = report_path
            self._counts = {k: 0 for k in self._counts}
        logger.info(
            f"[router] shadow started: "
            + (f"model {model} " if model else "")
            + f"version {version} at {sample:.0%} sample"
            + (f" -> {report_path}" if report_path else "")
        )
        return self.status()

    def stop(self) -> Dict[str, Any]:
        with self._lock:
            self._active = False
            self.version = None
            self.model = None
            self.sample = 0.0
        return self.status()

    @property
    def active(self) -> bool:
        with self._lock:
            return self._active

    def should_mirror(self, trace_id: str) -> bool:
        """Deterministic hash-of-trace-id sampling (the obs/trace
        tail-sampling idiom): every router instance mirrors the SAME
        subset, so a mirrored request's diff can be joined back to its
        primary trace."""
        with self._lock:
            if not self._active:
                return False
            sample = self.sample
        if sample >= 1.0:
            return True
        try:
            u = int(trace_id[:8], 16) / float(0xFFFFFFFF)
        except (ValueError, TypeError):
            return False
        return u < sample

    def record(
        self,
        trace_id: str,
        verdict: str,  # 'match' | 'mismatch' | 'mirror_errors' | 'no_candidate'
        detail: Optional[Dict[str, Any]] = None,
    ) -> None:
        with self._lock:
            if verdict in self._counts:
                self._counts[verdict] += 1
            if verdict in ("match", "mismatch"):
                self._counts["mirrored"] += 1
            path = self.report_path
        if path and detail is not None:
            line = json.dumps({
                "trace_id": trace_id, "verdict": verdict, **detail,
            })
            # Appends are O_APPEND-atomic for these line sizes; the lock
            # above only guards the counters.
            try:
                with open(path, "a") as f:
                    f.write(line + "\n")
            except OSError as e:
                logger.warning(f"[router] shadow report write failed: {e!r}")

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "active": self._active,
                "version": self.version,
                "model": self.model,
                "sample": self.sample,
                "report_path": self.report_path,
                "counts": dict(self._counts),
            }


# ------------------------------------------------------------ decision diff
def _diff_picks(a: Any, b: Any, tol: int) -> Tuple[bool, str]:
    """Compare two decoded pick lists ([{'sample': ...}, ...])."""
    try:
        sa = [int(p.get("sample", p.get("onset", -1))) for p in (a or [])]
        sb = [int(p.get("sample", p.get("onset", -1))) for p in (b or [])]
    except (AttributeError, TypeError):
        # One side isn't a pick list at all — a decision mismatch, not a
        # mirror transport error.
        return False, "shape mismatch: unparseable pick list"
    if len(sa) != len(sb):
        return False, f"count {len(sa)} vs {len(sb)}"
    for x, y in zip(sa, sb):
        if abs(x - y) > tol:
            return False, f"pick moved {abs(x - y)} samples ({x} vs {y})"
    return True, f"{len(sa)} picks within {tol} samples"


def _diff_value(a: float, b: float) -> Tuple[bool, str]:
    tol = max(VALUE_ABS_TOL, VALUE_REL_TOL * abs(a))
    ok = abs(a - b) <= tol
    return ok, f"|{a:.4g} - {b:.4g}| {'<=' if ok else '>'} {tol:.4g}"


def _diff_result(
    a: Mapping[str, Any], b: Mapping[str, Any], tol: int
) -> Dict[str, Any]:
    """Decision-level diff of ONE task's decoded result dict (the
    /predict response shapes of serve/pool.py::decode_outputs): pick positions for
    picking heads, argmax class for classifiers, tolerance-scaled values
    for regression heads. Version/bookkeeping fields are ignored — the
    whole point is that versions DIFFER."""
    fields: Dict[str, Any] = {}
    match = True
    skip = {"model", "model_version", "task", "trunk_runs", "variant",
            "windows", "record_samples"}
    for key in sorted(set(a) | set(b)):
        if key in skip:
            continue
        if key not in a or key not in b:
            fields[key] = {"match": False, "detail": "missing on one side"}
            match = False
            continue
        va, vb = a[key], b[key]
        if key in ("ppk", "spk", "det"):
            ok, detail = _diff_picks(va, vb, tol)
        elif isinstance(va, Mapping) and "class" in va:
            if isinstance(vb, Mapping):
                ok = va.get("class") == vb.get("class")
                detail = f"class {va.get('class')} vs {vb.get('class')}"
            else:
                # A head whose output SHAPE diverged between versions is
                # the strongest possible mismatch — it must report as
                # one, not crash the mirror thread into 'mirror_errors'.
                ok = False
                detail = f"shape mismatch: dict vs {type(vb).__name__}"
        elif isinstance(va, (int, float)) and isinstance(vb, (int, float)):
            ok, detail = _diff_value(float(va), float(vb))
        else:
            ok, detail = va == vb, "direct compare"
        fields[key] = {"match": ok, "detail": detail}
        match = match and ok
    return {"match": match, "fields": fields}


def decision_diff(
    incumbent: Mapping[str, Any],
    candidate: Mapping[str, Any],
    pick_tol_samples: int = PICK_TOL_SAMPLES,
) -> Dict[str, Any]:
    """Diff two /predict response bodies at decision level — the shadow
    mode comparator. Handles both the single-task shape and the
    multi-task ``{"tasks": {task: result}}`` fan-out (recursing per
    task). Returns ``{"match": bool, ...detail...}``."""
    if "tasks" in incumbent or "tasks" in candidate:
        ta = incumbent.get("tasks") or {}
        tb = candidate.get("tasks") or {}
        tasks: Dict[str, Any] = {}
        match = True
        for t in sorted(set(ta) | set(tb)):
            if t not in ta or t not in tb:
                tasks[t] = {"match": False, "detail": "missing on one side"}
                match = False
                continue
            tasks[t] = _diff_result(ta[t], tb[t], pick_tol_samples)
            match = match and tasks[t]["match"]
        return {"match": match, "tasks": tasks}
    return _diff_result(incumbent, candidate, pick_tol_samples)
