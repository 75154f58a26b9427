"""The DISC error taxonomy — every layer raises *through* these classes.

DISC compiles **during** serving: buckets, §4.4 escalations, and
promote-on-change all hit the compiler on the hot path, so a compile or
launch failure is a *runtime* event that the serving layer must survive,
not a build-time event that may abort the process.  This module gives
every layer one vocabulary for that:

* :class:`DiscError` — base class carrying ``transient`` (retry may
  succeed: backend ``RESOURCE_EXHAUSTED``, allocator pressure) vs
  permanent (retry cannot help: a :class:`~repro.core.constraints.\
ConstraintViolation`, an :class:`~repro_torch.frontends.fx_frontend.\
UnsupportedPrimitiveError`, a malformed spec).
* :class:`CompileError` — lowering/compilation of a bucket, exact
  escalation, or promote-on-change re-lower failed.  Subclasses
  ``ValueError`` as well so existing ``except ValueError`` call sites
  (and tests) keep working across the wrap.
* :class:`LaunchError` — a compiled artifact failed at call time.
* :class:`PoolExhausted` — the paged-KV pool cannot make progress
  (a request exceeded its bounded recompute budget under preemption).
* :class:`DeadlineExceeded` — a request's ``deadline_s`` passed before
  it completed.

:func:`classify_transient` is the single transient-vs-permanent decision
point; :func:`retry_call` is the capped-exponential-backoff helper the
degradation ladders share.  ``CONTROL_EXCEPTIONS`` names the exceptions
no ladder may ever swallow (``KeyboardInterrupt``/``SystemExit``/...).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

__all__ = [
    "DiscError", "CompileError", "LaunchError", "NoDeviceError",
    "PoolExhausted",
    "DeadlineExceeded", "RetryPolicy", "classify_transient",
    "wrap_compile_error", "wrap_launch_error", "retry_call",
    "CONTROL_EXCEPTIONS",
]

#: exceptions that must always propagate — no fallback ladder, retry
#: loop, or rollback handler may swallow these
CONTROL_EXCEPTIONS: Tuple[type, ...] = (
    KeyboardInterrupt, SystemExit, GeneratorExit)

#: substrings of backend runtime-error messages that mark the failure as
#: transient (resource pressure, not a broken program) — PyTorch surfaces
#: allocator failures as ``CUDA out of memory`` / OOM text
_TRANSIENT_MARKERS: Tuple[str, ...] = (
    "RESOURCE_EXHAUSTED", "resource exhausted", "out of memory", "OOM")


class DiscError(Exception):
    """Base of the taxonomy.  ``transient`` answers the only question a
    degradation ladder asks: is retrying this exact operation allowed to
    succeed?"""

    def __init__(self, message: str, *, transient: bool = False):
        super().__init__(message)
        self.transient = transient


class CompileError(DiscError, ValueError):
    """Bucket / exact-escalation / promote-on-change compilation failed.

    Also a ``ValueError``: most permanent compile failures *are* value
    errors in the user's specs (shape contract violations, invalid
    sharding asks), and pre-taxonomy call sites catch ``ValueError``.
    """


class LaunchError(DiscError, RuntimeError):
    """A compiled artifact raised at call time (device launch failed)."""


class NoDeviceError(DiscError, RuntimeError):
    """The artifact was asked to run on the card (the default device) and
    no CUDA device is present.  Raised instead of carrying on on the CPU;
    pass ``device="cpu"`` to run the plain versions on purpose."""


class PoolExhausted(DiscError, RuntimeError):
    """Paged-KV pool pressure defeated a request: it hit its bounded
    recompute budget (preempted + recomputed too many times) and is
    retired FAILED instead of spinning in the preemption loop forever."""


class DeadlineExceeded(DiscError, TimeoutError):
    """A request's ``deadline_s`` passed before it completed; checked at
    admission and between engine steps."""


def classify_transient(exc: BaseException) -> bool:
    """The transient-vs-permanent decision, in one place.

    * :class:`DiscError` — trust its own flag (already classified).
    * ``ConstraintViolation`` / ``UnsupportedPrimitiveError`` /
      ``TypeError`` — permanent: the program or spec is wrong and will
      be wrong again.
    * anything whose message carries a resource-pressure marker
      (``RESOURCE_EXHAUSTED``, OOM) — transient: memory may free up.
    * everything else — permanent (the conservative default: blind
      retries of unknown failures just triple the latency of failing).
    """
    if isinstance(exc, DiscError):
        return exc.transient
    from .core.constraints import ConstraintViolation
    from .frontends.fx_frontend import UnsupportedPrimitiveError
    if isinstance(exc, (ConstraintViolation, UnsupportedPrimitiveError,
                        TypeError)):
        return False
    msg = str(exc)
    return any(m in msg for m in _TRANSIENT_MARKERS)


def wrap_compile_error(exc: BaseException, what: str) -> CompileError:
    """Wrap ``exc`` (raised while compiling ``what``) into the taxonomy,
    preserving the original message and classification.  Already-wrapped
    errors pass through unchanged."""
    if isinstance(exc, CompileError):
        return exc
    err = CompileError(
        f"compile failed ({what}): {type(exc).__name__}: {exc}",
        transient=classify_transient(exc))
    err.__cause__ = exc     # chain even when the raise site omits `from`
    return err


def wrap_launch_error(exc: BaseException, what: str) -> LaunchError:
    """Wrap ``exc`` (raised while launching ``what``) into the taxonomy.
    A :class:`CompileError` escaping a launch (first call compiles inside
    dispatch) stays a CompileError — re-raise it, don't wrap."""
    if isinstance(exc, LaunchError):
        return exc
    err = LaunchError(
        f"launch failed ({what}): {type(exc).__name__}: {exc}",
        transient=classify_transient(exc))
    err.__cause__ = exc     # chain even when the raise site omits `from`
    return err


@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff for *transient* failures.

    ``max_retries`` additional attempts after the first; sleeps
    ``backoff_s * multiplier**attempt`` between attempts, capped at
    ``cap_s``.  Permanent failures never retry.
    """

    max_retries: int = 2
    backoff_s: float = 0.01
    multiplier: float = 2.0
    cap_s: float = 0.25

    def delay(self, attempt: int) -> float:
        return min(self.backoff_s * (self.multiplier ** attempt), self.cap_s)


#: the default ladder policy shared by compile + launch retry loops
DEFAULT_RETRY = RetryPolicy()


def retry_call(fn: Callable[[], Any], *, policy: RetryPolicy = DEFAULT_RETRY,
               wrap: Callable[[BaseException], DiscError] = None,
               on_retry: Optional[Callable[[int, DiscError], None]] = None,
               sleep: Callable[[float], None] = time.sleep) -> Any:
    """Call ``fn``, retrying transient failures per ``policy``.

    ``wrap`` converts a raw exception into the taxonomy (e.g.
    ``lambda e: wrap_compile_error(e, "bucket (8, 64)")``); the wrapped
    error decides transience.  ``on_retry(attempt, err)`` is invoked
    before each sleep (counter hooks).  Control-flow exceptions always
    propagate unwrapped.
    """
    wrap = wrap or (lambda e: wrap_launch_error(e, "call"))
    attempt = 0
    while True:
        try:
            return fn()
        except CONTROL_EXCEPTIONS:
            raise
        except Exception as e:  # noqa: BLE001 — classified right below
            err = wrap(e)
            if not err.transient or attempt >= policy.max_retries:
                raise err from e
            if on_retry is not None:
                on_retry(attempt, err)
            sleep(policy.delay(attempt))
            attempt += 1
