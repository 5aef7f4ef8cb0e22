"""The prefix-certified exact schedule (``PipelineConfig.certify_prefix``).

Port of the JAX package's ``models/schedules_experimental.py``, which
keeps it out of the hot round loop: result-identical to the plain exact
sweep, and measured slower than the certified schedule on the TPU. The
scheme and its soundness argument are the JAX package's:

- after the full round-0 descent each keyframe sorts its leaves by the
  certificate key ``mu = margin / (E0 + |m|)``, ``E0`` the mean leaf
  range of the scan floored at 1.0;
- each round adds the motion budget ``(A, C) += (|dt|, |dR|_F)``; a
  leaf moved at most ``A + C |m|`` since its keyframe's baseline, so
  the uncertified set ``{mu <= T}`` (``T`` a running max of
  ``max(A/E0, C)`` plus the fp floor) is a prefix of the sorted order
  that only grows, found with one ``searchsorted``;
- a keyframe whose prefix fits the ``certify_prefix`` = U buffer
  re-descends its first U sorted entries (masked to the prefix); one
  that overflows re-descends all its leaves, re-sorts them by the fresh
  margins and restarts its budget from this round's pose.

Differences of form: the JAX per-keyframe ``lax.cond(n_r <= U, prefix,
reset)`` is computed for every keyframe at once — the prefix buffers and
the full sweeps descend in one batched call — and each keyframe keeps
its own branch's result, so no device value is read on the host.
"""

from __future__ import annotations

import torch

from madicp_tpu_torch.ops.icp_core import gn_se3_step, terms_from_payload
from madicp_tpu_torch.utils.timing import phase


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def prefix_certified_rounds(
    cfg,
    kf_valid_f: torch.Tensor,
    leaves_pts: torch.Tensor,
    leaves_valid: torch.Tensor,
    X0: torch.Tensor,
    *,
    descend,
    terms_scan,
    reduce_terms,
    kv: torch.Tensor,
    nv: torch.Tensor,
    stamps=None,
):
    """The prefix-certified exact schedule (``cfg.certify_prefix > 0``)
    over a batch of B sequences: ``kf_valid_f`` (B, K), leaves (B, L, 3)
    and (B, L), ``X0`` (B, 4, 4).

    ``descend(X, need, margin, pts=...)`` and ``terms_scan(X, payload,
    with_matched)`` are ``icp_rounds``' batched descent over the keyframe
    rings and its canonical-order terms; ``reduce_terms`` its reduction
    over the keyframe group, applied here to the sorted terms. Returns
    ``(X, H_last, matched, n_descents)``.
    """
    dtype, dev = cfg.dtype, X0.device
    B, K = kf_valid_f.shape
    L = leaves_pts.shape[1]
    n_its = cfg.max_icp_iterations
    U = min(cfg.certify_prefix, L)
    eps64 = 64.0 * torch.finfo(dtype).eps
    live = kf_valid_f > 0  # (B, K)
    # the valid leaves sort first in every keyframe's order (masked entries
    # carry the largest mu), so they stay a prefix: the terms walk nv of them
    terms_kw = dict(b_max=cfg.b_max, b_ratio=cfg.b_ratio, rho_ker=cfg.rho_ker,
                    n_live=nv[:, None])

    # round 0: full descent against every live keyframe, recording path
    # margins (X0 is the baseline pose of every certificate)
    _, payload0, margin0 = descend(X0, leaves_valid[:, None, :] & live[:, :, None], True)
    n_descents = kv * nv
    if n_its == 1:
        with phase(stamps, "terms"):
            H_last, b_last, matched = terms_scan(X0, payload0, True)
            return gn_se3_step(X0, H_last, b_last), H_last, matched, n_descents

    with phase(stamps, "terms"):
        X1 = gn_se3_step(X0, *terms_scan(X0, payload0, False))
    # radius scale of the 1D certificate key (see the JAX module): sound
    # for any E0 > 0; the floor of 1.0 keeps the skip guard's fp term above
    # eps_cert on close-range scenes
    with phase(stamps, "assoc"):
        E0 = torch.clamp(
            torch.sum(torch.where(leaves_valid, _norm(leaves_pts), 0.0), dim=-1)
            / torch.clamp(nv.to(dtype), min=1.0),
            min=1.0,
        )[:, None]  # (B, 1)

    def sort_kf(margin, payload, lps, lv, order):
        """Each keyframe's certification baseline from a full
        re-association: its entries in ascending ``mu`` (stable, like
        ``jnp.argsort``; masked entries carry the dtype's max margin and
        sort last). ``order`` maps sorted to canonical leaf positions."""
        mu = margin / (E0[..., None] + _norm(lps))
        perm = torch.argsort(mu, dim=-1, stable=True)  # (B, K, L)
        take = lambda a: torch.take_along_dim(  # noqa: E731
            a, perm.reshape(perm.shape + (1,) * (a.dim() - 3)), dim=2)
        return take(payload), take(lps), take(lv), take(mu), take(order)

    with phase(stamps, "assoc"):
        sstate = sort_kf(
            margin0, payload0, leaves_pts[:, None].expand(B, K, L, 3),
            leaves_valid[:, None].expand(B, K, L),
            torch.arange(L, device=dev).expand(B, K, L),
        )
        iota_u = torch.arange(U, device=dev)

    def terms_sorted(X, sstate, with_matched: bool):
        payload, lps, lv, _, order = sstate
        terms = terms_from_payload(payload, lps, lv, X[:, None], **terms_kw,
                                   with_matched=with_matched)
        H = torch.einsum("bk,bkij->bij", kf_valid_f, terms.H)
        b = torch.einsum("bk,bki->bi", kf_valid_f, terms.b)
        if with_matched:
            # back to canonical leaf positions (each keyframe's order
            # differs) before the any over keyframes and processes
            m = torch.zeros((B, K, L), dtype=torch.bool, device=dev).scatter_(
                2, order, terms.matched & live[..., None])
            return reduce_terms((H, b, torch.any(m, dim=1)))
        return reduce_terms((H, b))

    def motion_budget(Xa, Xb):
        """Per-round displacement bound components (B, 1): a query moves
        ``|(Xb - Xa) m| <= |dt| + |dR|_F |m|``. Frobenius, not trig: the
        bound's own rounding must stay under the eps64 floor."""
        dR = Xb[:, :3, :3] - Xa[:, :3, :3]
        return (_norm(Xb[:, :3, 3] - Xa[:, :3, 3])[:, None],
                torch.sqrt(torch.sum(dR * dR, dim=(1, 2)))[:, None])

    def reassoc_round(X, sstate, A, C, T, nd):
        """One round's re-association. ``T`` (B, K) is a running max, so
        within an epoch a keyframe's uncertified prefix only grows: a
        skipped entry (mu > T) has margin > A + C r + eps_cert and its
        cache provably holds the epoch's leaf."""
        with phase(stamps, "assoc"):
            return _reassoc(X, sstate, A, C, T, nd)

    def _reassoc(X, sstate, A, C, T, nd):
        payload, lps, lv, mu, order = sstate
        T = torch.maximum(
            T, torch.maximum(A / E0, C) + eps64 * (1.0 + _norm(X[:, :3, 3]))[:, None])
        n_r = torch.searchsorted(mu, T[..., None], right=True)  # (B, K, 1)
        fits = (n_r <= U)[..., 0]  # (B, K): the prefix branch, else the reset
        act_p = lv[..., :U] & (iota_u < n_r) & (live & fits)[..., None]
        act_r = lv & (live & ~fits)[..., None]
        _, pl, mg = descend(
            X, torch.cat([act_p, act_r], dim=-1), True,
            pts=torch.cat([lps[:, :, :U], lps], dim=2),
        )
        # prefix branch: fresh payloads for the active prefix entries
        head = torch.where(act_p[..., None], pl[:, :, :U], payload[:, :, :U])
        kept = (torch.cat([head, payload[:, :, U:]], dim=2), lps, lv, mu, order)
        # reset branch: the whole leaf set re-descended, re-sorted by its
        # fresh margins; this round's pose is the keyframe's new baseline
        reset = sort_kf(
            mg[:, :, U:], torch.where(act_r[..., None], pl[:, :, U:], payload), lps, lv, order)
        sstate = tuple(
            torch.where(fits.reshape((B, K) + (1,) * (a.dim() - 2)), a, b)
            for a, b in zip(kept, reset)
        )
        A, C, T = (torch.where(fits, v, 0.0) for v in (A, C, T))
        return sstate, A, C, T, nd + act_p.sum(dim=(1, 2)) + act_r.sum(dim=(1, 2))

    with phase(stamps, "assoc"):
        zeros_k = torch.zeros((B, K), dtype=dtype, device=dev)
    A, C, T = zeros_k, zeros_k, zeros_k
    Xp, X = X0, X1
    for _ in range(1, n_its - 1):
        with phase(stamps, "terms"):  # the certificate's budget, as the slack pass
            dt, dR = motion_budget(Xp, X)
        sstate, A, C, T, n_descents = reassoc_round(X, sstate, A + dt, C + dR, T, n_descents)
        with phase(stamps, "terms"):
            Xp, X = X, gn_se3_step(X, *terms_sorted(X, sstate, False))
    # final round: matched flags + H_last from this round's
    # re-association, like the reference's last-iteration reset
    # (pipeline.cpp:172-176)
    with phase(stamps, "terms"):
        dt, dR = motion_budget(Xp, X)
    sstate, A, C, T, n_descents = reassoc_round(X, sstate, A + dt, C + dR, T, n_descents)
    with phase(stamps, "terms"):
        H_last, b_last, matched = terms_sorted(X, sstate, True)
        X = gn_se3_step(X, H_last, b_last)
    return X, H_last, matched, n_descents
