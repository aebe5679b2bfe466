"""Backpressure — ≙ packages/backpressure (Backpressure.apply/release +
ApplyReleaseBackpressureAuth/auth.pony).

The reference package lets an actor tell the runtime "send to me slower"
when it experiences pressure the runtime cannot observe — a stalled
socket, a saturated external queue (packages/backpressure/
backpressure.pony module docs; the runtime side is
pony_apply_backpressure / pony_release_backpressure,
src/libponyrt/actor/actor.c:1137-1162). Here the runtime side is the
`pressured` actor column: senders to a pressured actor mute at delivery
time and release after release() once occupancy also recovers
(delivery.py mute triggers; engine.py unmute pass).

Mirrors the reference's capability-security shape: calling apply/release
requires an `ApplyReleaseBackpressureAuth` token derived from the
runtime's root authority (≙ auth.pony deriving from AmbientAuth), so a
library can be granted *only* this power.

    from ponyc_tpu_torch.stdlib import backpressure as bp
    auth = bp.ApplyReleaseBackpressureAuth(rt.ambient_auth())
    bp.apply(auth, actor_id)
    ...
    bp.release(auth, actor_id)
"""

from __future__ import annotations


class ApplyReleaseBackpressureAuth:
    """Capability token for apply/release (≙ backpressure/auth.pony)."""

    def __init__(self, ambient):
        from ..runtime.runtime import AmbientAuth
        if not isinstance(ambient, AmbientAuth):
            raise TypeError(
                "ApplyReleaseBackpressureAuth requires the runtime's "
                "ambient authority (rt.ambient_auth())")
        self._rt = ambient._rt


def apply(auth: ApplyReleaseBackpressureAuth, actor_id) -> None:
    """≙ Backpressure.apply(auth): mark `actor_id` under pressure."""
    if not isinstance(auth, ApplyReleaseBackpressureAuth):
        raise TypeError("apply requires an ApplyReleaseBackpressureAuth")
    auth._rt.apply_backpressure(actor_id)


def release(auth: ApplyReleaseBackpressureAuth, actor_id) -> None:
    """≙ Backpressure.release(auth): clear the pressure mark."""
    if not isinstance(auth, ApplyReleaseBackpressureAuth):
        raise TypeError("release requires an ApplyReleaseBackpressureAuth")
    auth._rt.release_backpressure(actor_id)
