"""Port parity of the generic filter modules: ``models/distributions.py``
and ``filters/pf.py``.

Tolerances: log-densities against JAX's on the same numpy inputs 1e-5
(float32, rtol 1e-5); samplers by their moments over 200k draws (mean
and standard deviation within 1-2 %, stated per case) and, where the
noise is injected, against JAX's formula with JAX's noise (1e-5); one
``pf.step`` with JAX's resampling uniform injected, particles and
weights 1e-5 and equal parents.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbot_ros_tpu.filters import pf as jpf
from dbot_ros_tpu.models import distributions as jd
from dbot_ros_tpu_torch.filters import pf
from dbot_ros_tpu_torch.models import distributions as d

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def spd(rng, dim, batch=()):
    a = rng.standard_normal(batch + (dim, dim))
    return (a @ np.swapaxes(a, -1, -2) + dim * np.eye(dim)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# log-densities against JAX
# ---------------------------------------------------------------------------

def test_gaussian_logpdf_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 4)).astype(np.float32)
    mean = rng.standard_normal((5, 4)).astype(np.float32)
    cov = spd(rng, 4, (5,))
    want = np.asarray(jd.gaussian_logpdf(jnp.asarray(x), jnp.asarray(mean),
                                         jnp.asarray(cov)))
    got = d.gaussian_logpdf(t(x), t(mean), t(cov)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


SCALAR_CASES = {
    "truncated_gaussian": (
        lambda m, x: m.truncated_gaussian_logpdf(x, 0.1, 0.3, -0.2, 0.5)),
    "uniform": lambda m, x: m.uniform_logpdf(x, -0.5, 0.7),
    "exponential": lambda m, x: m.exponential_logpdf(x, 2.5),
    "exponential_truncated": (
        lambda m, x: m.exponential_logpdf(x, 2.5, 0.1, 1.0)),
    "cauchy": lambda m, x: m.cauchy_logpdf(x, 0.2, 0.4),
}


@pytest.mark.parametrize("name", sorted(SCALAR_CASES))
def test_scalar_logpdfs_match_jax(name):
    x = np.linspace(-1.0, 1.5, 41).astype(np.float32)
    fn = SCALAR_CASES[name]
    want = np.asarray(fn(jd, jnp.asarray(x)))
    got = fn(d, t(x)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    assert ok.sum() > 10
    np.testing.assert_allclose(got[ok], want[ok], **TOL)


def test_discrete_functions_match_jax():
    rng = np.random.default_rng(1)
    log_w = (3.0 * rng.standard_normal((3, 50))).astype(np.float32)
    log_w[1, :10] = -np.inf
    for name in ("discrete_entropy", "discrete_kl_to_uniform"):
        want = np.asarray(getattr(jd, name)(jnp.asarray(log_w)))
        got = getattr(d, name)(t(log_w)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    particles = rng.standard_normal((50, 3)).astype(np.float32)
    wm, wc = jd.sum_of_deltas_moments(jnp.asarray(particles),
                                      jnp.asarray(log_w[0]))
    gm, gc = d.sum_of_deltas_moments(t(particles), t(log_w[0]))
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), **TOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **TOL)


# ---------------------------------------------------------------------------
# samplers: injected noise against JAX, drawn noise by moments
# ---------------------------------------------------------------------------

def test_samplers_with_jax_noise_match_jax():
    rng = np.random.default_rng(2)
    mean = rng.standard_normal(3).astype(np.float32)
    cov = spd(rng, 3)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jd.gaussian_sample(key, jnp.asarray(mean),
                                         jnp.asarray(cov), (7,)))
    eps = np.asarray(jax.random.normal(key, (7, 3), jnp.float32))
    got = d.gaussian_sample(t(mean), t(cov), (7,), eps=t(eps)).numpy()
    np.testing.assert_allclose(got, want, **TOL)

    want = np.asarray(jd.truncated_gaussian_sample(key, 0.1, 0.3, -0.2, 0.5,
                                                   (64,)))
    u = np.asarray(jax.random.uniform(key, (64,), jnp.float32))
    got = d.truncated_gaussian_sample(0.1, 0.3, -0.2, 0.5, u=t(u)).numpy()
    np.testing.assert_allclose(got, want, **TOL)

    fn = lambda x: jnp.stack([jnp.sin(x[0]) * x[1], x[2] ** 2])   # noqa
    my, cyy, cxy = jd.monte_carlo_transform(key, fn, jnp.asarray(mean),
                                            jnp.asarray(cov), 64)
    eps = np.asarray(jax.random.normal(key, (64, 3), jnp.float32))
    gy, gyy, gxy = d.monte_carlo_transform(
        lambda x: torch.stack([torch.sin(x[0]) * x[1], x[2] ** 2]),
        t(mean), t(cov), 64, eps=t(eps))
    np.testing.assert_allclose(gy.numpy(), np.asarray(my), **TOL)
    np.testing.assert_allclose(gyy.numpy(), np.asarray(cyy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gxy.numpy(), np.asarray(cxy), rtol=1e-4,
                               atol=1e-4)


N_DRAWS = 200_000


def moments(x):
    x = x.double()
    return float(x.mean()), float(x.std())


def test_samplers_by_moments():
    g = torch.Generator().manual_seed(0)
    mean = torch.tensor([0.5, -1.0])
    cov = torch.tensor([[2.0, 0.6], [0.6, 1.0]])
    x = d.gaussian_sample(mean, cov, (N_DRAWS,), generator=g)
    np.testing.assert_allclose(x.double().mean(0).numpy(), mean.numpy(),
                               atol=0.01)
    np.testing.assert_allclose(torch.cov(x.double().T).numpy(), cov.numpy(),
                               atol=0.02)
    m, s = moments(d.standard_gaussian_sample(3, (N_DRAWS,), generator=g))
    assert abs(m) < 0.01 and abs(s - 1) < 0.01

    x = d.truncated_gaussian_sample(0.1, 0.3, -0.2, 0.5, (N_DRAWS,),
                                    generator=g)
    assert float(x.min()) >= -0.2 and float(x.max()) <= 0.5
    # moments of the truncated normal, closed form
    a, b = (-0.2 - 0.1) / 0.3, (0.5 - 0.1) / 0.3
    phi = [math.exp(-v * v / 2) / math.sqrt(2 * math.pi) for v in (a, b)]
    z = 0.5 * (math.erf(b / math.sqrt(2)) - math.erf(a / math.sqrt(2)))
    mu = 0.1 + 0.3 * (phi[0] - phi[1]) / z
    var = 0.09 * (1 + (a * phi[0] - b * phi[1]) / z
                  - ((phi[0] - phi[1]) / z) ** 2)
    m, s = moments(x)
    assert abs(m - mu) < 0.005 and abs(s - math.sqrt(var)) < 0.005

    m, s = moments(d.uniform_sample(-0.5, 0.7, (N_DRAWS,), generator=g))
    assert abs(m - 0.1) < 0.005 and abs(s - 1.2 / math.sqrt(12)) < 0.005
    m, s = moments(d.exponential_sample(2.5, (N_DRAWS,), generator=g))
    assert abs(m - 0.4) < 0.005 and abs(s - 0.4) < 0.008
    c = d.cauchy_sample(0.2, 0.4, (N_DRAWS,), generator=g).double()
    q1, q2, q3 = torch.quantile(c[:100_000], torch.tensor(
        [0.25, 0.5, 0.75], dtype=torch.float64)).tolist()
    assert abs(q2 - 0.2) < 0.01 and abs((q3 - q1) / 2 - 0.4) < 0.01


def test_discrete_sample_frequencies_and_shapes():
    g = torch.Generator().manual_seed(1)
    p = torch.tensor([0.1, 0.6, 0.3])
    idx = d.discrete_sample(torch.log(p), (N_DRAWS,), generator=g)
    freq = torch.bincount(idx, minlength=3).double() / N_DRAWS
    np.testing.assert_allclose(freq.numpy(), p.numpy(), atol=0.005)
    batch = torch.log(torch.tensor([[0.5, 0.5, 0.0], [0.0, 0.0, 1.0]]))
    out = d.discrete_sample(batch, (1000, 2), generator=g)
    assert out.shape == (1000, 2)
    assert set(out[:, 0].tolist()) <= {0, 1} and set(out[:, 1].tolist()) \
        == {2}
    assert d.discrete_sample(torch.log(p), generator=g).shape == ()
    with pytest.raises(ValueError, match="batch"):
        d.discrete_sample(batch, (5, 3))


# ---------------------------------------------------------------------------
# filters/pf.py
# ---------------------------------------------------------------------------

def test_pf_step_with_jax_uniform_matches_jax():
    rng = np.random.default_rng(3)
    P = 64
    parts = rng.standard_normal((P, 2)).astype(np.float32)
    obs = np.array([0.3, -0.2], np.float32)
    jb = jpf.init(jax.random.PRNGKey(7), {"x": jnp.asarray(parts),
                                          "v": jnp.zeros((P,))})
    b = pf.init({"x": t(parts), "v": torch.zeros(P)})
    assert b.log_weights.shape == (P,)

    def loglik(p, o, lib):
        return -0.5 * lib.sum((p["x"] - o) ** 2, -1) / 0.05

    for s in range(3):
        # JAX's draws: split(key, 3) → (key, k_prop, k_res); u from k_res
        _, k_prop, k_res = jax.random.split(jb.key, 3)
        noise = np.asarray(jax.random.normal(k_prop, (P, 2)))
        u = float(jax.random.uniform(k_res, ()))
        jb = jpf.step(
            jb, jnp.asarray(obs),
            lambda k, p: {"x": p["x"] + 0.1 * jax.random.normal(
                k, p["x"].shape), "v": p["v"] + 1.0},
            lambda p, o: loglik(p, o, jnp))
        b = pf.step(b, t(obs),
                    lambda p: {"x": p["x"] + 0.1 * t(noise),
                               "v": p["v"] + 1.0},
                    lambda p, o: loglik(p, o, torch), u=u)
        np.testing.assert_allclose(b.particles["x"].numpy(),
                                   np.asarray(jb.particles["x"]), **TOL)
        np.testing.assert_array_equal(b.particles["v"].numpy(),
                                      np.asarray(jb.particles["v"]))
        np.testing.assert_allclose(b.log_weights.numpy(),
                                   np.asarray(jb.log_weights), **TOL)
    want = jpf.mean(jb)
    got = pf.mean(b)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]),
                               **TOL)
    # the weights collapsed at least once: resampling ran
    assert len(set(b.particles["x"][:, 0].tolist())) < P


def test_pf_tracks_a_constant_and_resamples_by_ess():
    g = torch.Generator().manual_seed(0)
    b = pf.init(torch.randn(500, generator=g) * 2.0)
    for _ in range(20):
        b = pf.step(b, torch.tensor(1.5),
                    lambda p: p + 0.05 * torch.randn(p.shape, generator=g),
                    lambda p, o: -0.5 * (p - o) ** 2 / 0.01, generator=g)
    assert abs(float(pf.mean(b)) - 1.5) < 0.02
    # a flat likelihood never drops the ESS: no resampling, weights kept
    before = pf.init(torch.arange(10.0))
    after = pf.step(before, None, lambda p: p,
                    lambda p, o: torch.zeros_like(p), u=0.5)
    assert torch.equal(after.particles, before.particles)
