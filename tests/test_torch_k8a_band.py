"""chip_smoke.py's check of K8a (``sign_bound``) against the float64 bounds
of its own relaxations.

K8a and its plain version are f32 sums of the same terms in different
orders; where the terms cancel, either can round a few tens to a few
hundred f32 ulps past the f64 bound.  The check therefore asks the
kernel's bounds to contain the f64 ones up to the tolerance that already
holds them to the plain version's (``sign_bound_band``).  The boxes below
are the kernel's and the plain version's misses recorded on an H100 by
``probes/k8a_containment.py`` (AC-S1 twin, node-capped plain sign
frontiers at alpha_iters 8): each fails the strict containment and passes
the band, and a bound moved past the band still fails.
"""
import pytest
import torch

import chip_smoke as cs

# (lo, hi) of the kernel, the plain version and the f64 reference.
RECORDED = [
    ((-1.2782988548278809, 2.332192897796631), (-1.2783293724060059, 2.3322081565856934),
     (-1.2783017529467884, 2.3321651656338247)),
    ((-4.155248641967773, -6.571084976196289), (-4.155340194702148, -6.571054458618164),
     (-4.155280684743275, -6.571136187589673)),
    ((5.40688943862915, -3.222769021987915), (5.406919956207275, -3.22267746925354),
     (5.406958040986538, -3.2227636373708464)),
    ((-1.8503613471984863, 1.4574780464172363), (-1.8504071235656738, 1.4575390815734863),
     (-1.850366951695733, 1.4575214278925728)),
    ((0.11153155565261841, 3.2081782817840576), (0.11153155565261841, 3.2082393169403076),
     (0.11157265410763273, 3.208179765806591)),
    ((1.7454649209976196, -1.2632719278335571), (1.7454954385757446, -1.2632566690444946),
     (1.7454951600353468, -1.2632689630878247)),
    ((-6.969537734985352, -5.175069808959961), (-6.969583511352539, -5.17512321472168),
     (-6.96953935243053, -5.175174485729286)),
]
# The plain version's own misses in the same runs (kernel equal to plain).
PLAIN_MISSES = [
    ((1.7454954385757446, -1.2632566690444946), (1.7454951600353468, -1.2632689630878247)),
    ((-2.7037949562072754, -2.8101820945739746), (-2.7037932272272656, -2.810164139303282)),
]


def _case(kernel, plain, f64):
    """(k_out, k_ab, ref) for :func:`chip_smoke.sign_bound_verdict` of B
    boxes with one hidden neuron each, scores 0, α/β and the rest equal."""
    col = lambda rows, i, dt=torch.float32: torch.tensor([r[i] for r in rows], dtype=dt)
    B = len(kernel)
    zeros = torch.zeros(B, 1)
    res = [torch.zeros(B, 1, dtype=torch.int8)]
    feas = torch.ones(B, dtype=torch.bool)
    ab = torch.zeros(B, 4)
    ref = ((col(plain, 0), col(plain, 1), feas, [zeros], res), ab,
           torch.zeros(B, dtype=torch.bool), col(f64, 0, torch.float64),
           col(f64, 1, torch.float64), [zeros])
    return (col(kernel, 0), col(kernel, 1), feas, [zeros], res), ab, ref


def test_recorded_misses_fail_containment_and_pass_the_band():
    kernel, plain, f64 = zip(*RECORDED)
    k_out, k_ab, ref = _case(kernel, plain, f64)
    strict = (k_out[0].double() > ref[3]) | (k_out[1].double() < ref[4])
    assert strict.all()
    assert cs.sign_bound_verdict(k_out, k_ab, ref) is None
    band = cs.sign_bound_band(ref[0][0], ref[0][1])
    gap = torch.maximum(k_out[0].double() - ref[3], ref[4] - k_out[1].double())
    assert float((gap / band).max()) < 0.5


def test_plain_misses_pass_the_band():
    plain, f64 = zip(*PLAIN_MISSES)
    k_out, k_ab, ref = _case(plain, plain, f64)
    assert ((k_out[0].double() > ref[3]) | (k_out[1].double() < ref[4])).all()
    assert cs.sign_bound_verdict(k_out, k_ab, ref) is None


@pytest.mark.parametrize("side", ["lo", "hi"])
def test_a_bound_past_the_band_fails(side):
    kernel, plain, f64 = zip(*RECORDED)
    k_out, k_ab, ref = _case(kernel, plain, f64)
    band = cs.sign_bound_band(ref[0][0], ref[0][1])
    b = 3
    i, sign, edge = (0, 1.0, ref[3]) if side == "lo" else (1, -1.0, ref[4])
    moved = k_out[i].clone()
    moved[b] = float(edge[b] + sign * 1.5 * band[b])
    k_out = k_out[:i] + (moved,) + k_out[i + 1:]
    why = cs.sign_bound_verdict(k_out, k_ab, ref)
    assert why is not None and ("miss the f64 bounds" in why or "bound error" in why)
