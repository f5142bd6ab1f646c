"""Open-loop serving front end: bounded queues, deadlines, load shedding.

Port of ``repro.serve.frontend``.  ``Guardrail.admit`` is a fixed-shape
batch program; production traffic is not — requests arrive one at a
time, from many tenants, at whatever rate the world offers.  An
overloaded closed loop just slows its own offered rate, while an
overloaded OPEN loop grows a queue without bound and every request's
latency diverges.  This front end makes overload a measured, bounded
event instead:

* **Coalescing**: requests queue and are served as mixed-tenant batches
  of the guardrail's fixed shape ``B`` — short batches pad with NaN rows,
  which the guardrail's quarantine path absorbs (padding is never
  inserted into any sketch; ``pad_rows`` counts them, so
  ``g.quarantined - pad_rows`` is the dirty traffic).
* **Bounded queue**: at most ``max_queue`` requests wait; beyond that,
  arrivals shed immediately (tail drop).
* **Deadlines**: every request carries an absolute deadline.  ``pump``
  sheds, BEFORE serving, any request that could not make its deadline
  even if it rode the very next batch (measured EWMA service time, the
  ``admit`` call).
* **Policy-honoring shedding**: a shed request is answered with its
  tenant's ``fail_policy`` (``Guardrail.fail_open_mask``, a host array):
  fail_open tenants shed to ADMIT, fail_closed tenants to REJECT — the
  verdict a quarantined row of that tenant gets.

Transfers: a batch is assembled on the host in one staging array that
every batch reuses (a fresh 64 MB array a batch at full width, 256 × 16 ×
4096 float32, costs more in page faults than the row copies), page-locked
when the guardrail is on the card (a pageable 64 MB copy takes several
times as long as a page-locked one), and handed to ``Guardrail.admit`` as
it is; the admit's ``torch.as_tensor`` is the
one host→device copy and its packed verdict block the one device→host
copy, which also ends the measured service time.  So a guardrail must not
keep the array past ``admit``.  ``pump`` adds no transfer or sync of its
own, and a shed (``_shed``) touches no device memory.  The host seconds
of assembly are counted in ``assembly_s``, outside the service time, as
the reference leaves them.

Single-threaded by design: ``submit``/``pump`` are called from one
serving loop; the clock is injectable so every shedding decision is
unit-testable with a fake clock.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FrontEndConfig:
    batch_size: int                  # the guardrail's fixed batch shape
    seq: int                         # fixed (S, D) request embed shape
    d_model: int
    max_queue: int = 256             # bounded: beyond this, tail-drop
    default_deadline: float = 0.050  # seconds of slack per request
    max_wait: float = 0.005          # serve a partial batch after this
    service_ewma: float = 0.3        # EWMA weight of the newest sample

    def __post_init__(self):
        if self.batch_size < 1 or self.max_queue < 1:
            raise ValueError("batch_size and max_queue must be >= 1")


@dataclasses.dataclass
class Ticket:
    """One request's lifecycle: queued → served | shed."""

    tenant: int
    deadline: float                  # absolute, front-end clock
    t_submit: float
    status: str = "queued"           # queued | served | shed
    admitted: bool | None = None
    reason: str | None = None        # queue_full | deadline (shed only)
    t_done: float | None = None

    @property
    def latency(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_submit


class FrontEnd:
    """Open-loop request batcher in front of one ``Guardrail``."""

    def __init__(self, guardrail, cfg: FrontEndConfig,
                 clock=time.perf_counter):
        self.g = guardrail
        self.cfg = cfg
        self.clock = clock
        self._q: collections.deque[tuple[Ticket, np.ndarray]] = \
            collections.deque()
        self._est_service: float | None = None   # EWMA sec per batch
        # the padded batch, reused: rows past the last batch's stay NaN
        self._stage = _staging((cfg.batch_size, cfg.seq, cfg.d_model),
                               getattr(guardrail, "device", None))
        self._staged = 0         # rows of _stage holding requests
        self.submitted = 0
        self.served = 0
        self.shed_queue_full = 0
        self.shed_deadline = 0
        self.pad_rows = 0        # NaN pad rows fed to the guardrail
        self.assembly_s = 0.0    # total host seconds assembling batches
        #                          (outside the service time)

    # -- intake ------------------------------------------------------------

    def submit(self, embed: np.ndarray, tenant: int = 0,
               deadline: float | None = None) -> Ticket:
        """Enqueue one (S, D) request.  Never blocks: a full queue sheds
        immediately (the bounded-queue contract).

        ``deadline`` is ABSOLUTE on the front-end clock; ``None`` derives
        one as submit time + ``cfg.default_deadline`` slack (callers that
        anchor deadlines to scheduled arrivals must not have them
        re-anchored to the submit call)."""
        now = self.clock()
        t = Ticket(tenant=int(tenant),
                   deadline=(now + self.cfg.default_deadline
                             if deadline is None else float(deadline)),
                   t_submit=now)
        self.submitted += 1
        if len(self._q) >= self.cfg.max_queue:
            self._shed(t, "queue_full")
            return t
        embed = np.asarray(embed, np.float32)
        if embed.shape != (self.cfg.seq, self.cfg.d_model):
            raise ValueError(f"request embed shape {embed.shape} != "
                             f"({self.cfg.seq}, {self.cfg.d_model})")
        self._q.append((t, embed))
        return t

    def _shed(self, ticket: Ticket, reason: str) -> None:
        mask = self.g.fail_open_mask          # host array: no device access
        fail_open = bool(mask[ticket.tenant if len(mask) > 1 else 0])
        ticket.status = "shed"
        ticket.reason = reason
        ticket.admitted = fail_open           # fail_open ⇒ shed-to-admit
        ticket.t_done = self.clock()
        if reason == "queue_full":
            self.shed_queue_full += 1
        else:
            self.shed_deadline += 1

    # -- service -----------------------------------------------------------

    @property
    def queue_len(self) -> int:
        return len(self._q)

    @property
    def est_service(self) -> float:
        """EWMA seconds per served batch (0.0 until first measurement)."""
        return self._est_service or 0.0

    def ready(self) -> bool:
        """A batch is due: the queue fills the fixed shape, or the
        oldest waiter has been queued for ``max_wait``."""
        if not self._q:
            return False
        return (len(self._q) >= self.cfg.batch_size
                or self.clock() - self._q[0][0].t_submit
                >= self.cfg.max_wait)

    def pump(self, force: bool = False) -> int:
        """Serve at most one batch.  Returns requests served (0 when the
        batch is not due yet).  Deadline-aware: requests that cannot
        make their deadline even on the NEXT batch are shed first, so
        device capacity is never spent on already-lost requests."""
        now = self.clock()
        # Cold start: until ONE batch has been measured there is no
        # service estimate (est_service's 0.0 is a placeholder), so no
        # request is shed by deadline: the first pump also builds or
        # loads the kernels, and tickets routinely age past short
        # deadlines meanwhile.  The first real sample arms the shed path.
        if self._est_service is not None:
            est = self._est_service
            while self._q:
                ticket, _ = self._q[0]
                if now + est > ticket.deadline:
                    self._q.popleft()
                    self._shed(ticket, "deadline")
                else:
                    break
        if not self._q or not (force or self.ready()):
            return 0
        take = min(self.cfg.batch_size, len(self._q))
        batch = [self._q.popleft() for _ in range(take)]
        a0 = self.clock()
        embeds = self._stage
        tenants = np.zeros(self.cfg.batch_size, np.int32)
        for i, (tk, e) in enumerate(batch):
            embeds[i] = e
            tenants[i] = tk.tenant
        embeds[take:self._staged] = np.nan       # the last batch's extra rows
        self._staged = take
        self.pad_rows += self.cfg.batch_size - take
        t0 = self.clock()
        self.assembly_s += t0 - a0
        # the admit makes the one H2D copy and returns host verdicts
        # through its one D2H copy, so dt covers the device work
        if getattr(self.g, "multi_tenant", False):
            verdicts = self.g.admit(embeds, tenants)
        else:
            verdicts = self.g.admit(embeds)
        dt = self.clock() - t0
        w = self.cfg.service_ewma
        self._est_service = dt if self._est_service is None \
            else (1 - w) * self._est_service + w * dt
        done = self.clock()
        for i, (tk, _) in enumerate(batch):
            tk.status = "served"
            tk.admitted = bool(verdicts[i])
            tk.t_done = done
        self.served += take
        return take

    def drain(self) -> int:
        """Serve everything still queued (partial final batch forced)."""
        total = 0
        while self._q:
            total += self.pump(force=True)
        return total

    # -- observability -----------------------------------------------------

    def metrics(self) -> dict:
        shed = self.shed_queue_full + self.shed_deadline
        return {
            "submitted": self.submitted,
            "served": self.served,
            "shed_queue_full": self.shed_queue_full,
            "shed_deadline": self.shed_deadline,
            "shed_rate": shed / max(self.submitted, 1),
            "queue_len": self.queue_len,
            "est_service_s": self.est_service,
            "pad_rows": self.pad_rows,
        }


def _staging(shape, device) -> np.ndarray:
    """The NaN-filled staging array: a numpy view of page-locked memory
    when the guardrail's device is CUDA (CUDA then copies it by DMA
    straight from the array), plain numpy otherwise."""
    if device is not None and torch.device(device).type == "cuda":
        out = torch.empty(shape, dtype=torch.float32, pin_memory=True).numpy()
        out.fill(np.nan)
        return out
    return np.full(shape, np.nan, np.float32)
