"""Stereo layer tests: line search, inverse-depth filter, measurement model.

Uses synthetic band-limited textures with analytically-known disparities
(rectified pure-x-translation geometry: u_cmp = u_ref - fx*b*idepth), the
moral equivalent of the reference's closed-form geometry fixtures.
"""

import numpy as np
import jax
import jax.numpy as jnp

from flame_tpu.geometry import se3, camera, epipolar
from flame_tpu.params import FilterParams, LineStereoParams, MeasModelParams
from flame_tpu.stereo import line_stereo, filter as idfilter, meas_model
from flame_tpu.ops import gradients

FX = 100.0
BASELINE = 0.5
H, W = 96, 128


def texture(x, y):
    """Smooth non-periodic texture with strong x-gradient."""
    return (128.0 + 50.0 * np.sin(0.55 * x + 0.2 * y) + 30.0 * np.cos(0.23 * x)
            + 15.0 * np.sin(0.11 * y) + 10.0 * np.sin(0.037 * x * 1.7))


def make_pair(idepth_true):
    """Rectified stereo pair: cmp pixels shift left by fx*b*idepth."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img_ref = texture(xx, yy).astype(np.float32)
    disp = FX * BASELINE * idepth_true
    img_cmp = texture(xx + disp, yy).astype(np.float32)
    return jnp.asarray(img_ref), jnp.asarray(img_cmp), disp


def stereo_geo():
    K = camera.make_k(FX, FX, W / 2.0, H / 2.0)
    Kinv = camera.inv_k(K)
    T_ref = (se3.quat_identity(), jnp.zeros(3))
    T_cmp = (se3.quat_identity(), jnp.array([BASELINE, 0.0, 0.0]))
    return K, Kinv, epipolar.load_relative(K, Kinv, T_ref, T_cmp)


# ---------------------------------------------------------------------------
# line_stereo.match
# ---------------------------------------------------------------------------


def _patch_at(img_fn, x, y):
    """5-tap horizontal patch at float position (reference epi dir = +x)."""
    return np.array([img_fn(x + j, y) for j in (-2, -1, 0, 1, 2)],
                    dtype=np.float32)


def test_line_stereo_finds_planted_match():
    idepth = 0.2
    img_ref, img_cmp, disp = make_pair(idepth)
    # True match of ref pixel (x0, y0) is at x0 - disp in cmp.
    x0, y0 = 80.0, 48.0
    true_x = x0 - disp

    ref_patch = jnp.asarray(
        _patch_at(lambda x, y: texture(x + 0, y), x0, y0))[None, :]

    start = jnp.array([[true_x - 8.0, y0]])
    end = jnp.array([[true_x + 8.0, y0]])
    params = LineStereoParams()
    res = line_stereo.match(ref_patch, img_cmp, start, end,
                            jnp.ones(1), params, n_steps=34)
    assert int(res.status[0]) == line_stereo.SUCCESS
    assert abs(float(res.u_cmp[0, 0]) - true_x) < 0.25
    assert abs(float(res.u_cmp[0, 1]) - y0) < 1e-4
    assert float(res.residual[0]) < 100.0


def test_line_stereo_steps_do_not_depend_on_endpoint_rounding():
    """A segment padded to epilength_min is an integer number of steps
    long, and a near-horizontal epiline has a ~1e-6 px y step. Neither
    may let rounding of the endpoints decide which steps are searched:
    the match sits on the last step and must be found, with the same
    subpixel position, for every last-ulp perturbation of the segment."""
    idepth = 0.2
    _, img_cmp, disp = make_pair(idepth)
    x0, y0 = 80.0, 48.0
    true_x = x0 - disp
    ref_patch = jnp.asarray(_patch_at(texture, x0, y0))[None, :]
    params = LineStereoParams()
    n_steps = line_stereo.n_steps_for(3.0)
    found = []
    for dy in (-3e-6, -1e-6, 0.0, 1e-6, 3e-6):
        # Three steps long, ending on the true match.
        start = np.array([[true_x - 3.0, y0 - dy]], np.float32)
        end = np.array([[true_x, y0 + dy]], np.float32)
        res = line_stereo.match(ref_patch, img_cmp, jnp.asarray(start),
                                jnp.asarray(end), jnp.ones(1), params,
                                n_steps)
        assert int(res.best_idx[0]) == 3, dy
        found.append(np.asarray(res.u_cmp[0]))
    for u in found:
        np.testing.assert_allclose(u, found[2], atol=1e-3)


def test_line_stereo_subpixel_beats_integer():
    """With a non-integer true disparity, subpixel refinement must get closer
    than the best integer step."""
    idepth = 0.2137  # non-integer disparity
    img_ref, img_cmp, disp = make_pair(idepth)
    x0, y0 = 70.0, 40.0
    true_x = x0 - disp

    ref_patch = jnp.asarray(_patch_at(texture, x0, y0))[None, :]
    start = jnp.array([[true_x - 6.2, y0]])  # non-integer offset from truth
    end = jnp.array([[true_x + 7.8, y0]])

    res_sub = line_stereo.match(ref_patch, img_cmp, start, end, jnp.ones(1),
                                LineStereoParams(do_subpixel=True), 34)
    res_int = line_stereo.match(ref_patch, img_cmp, start, end, jnp.ones(1),
                                LineStereoParams(do_subpixel=False), 34)
    err_sub = abs(float(res_sub.u_cmp[0, 0]) - true_x)
    err_int = abs(float(res_int.u_cmp[0, 0]) - true_x)
    assert int(res_sub.status[0]) == line_stereo.SUCCESS
    assert err_sub <= err_int + 1e-5
    assert err_sub < 0.2


def test_line_stereo_max_cost_failure():
    """A patch that matches nothing on the line must fail with MAX_COST."""
    img_ref, img_cmp, _ = make_pair(0.2)
    ref_patch = jnp.asarray([[255.0, 0.0, 255.0, 0.0, 255.0]])  # alien patch
    start = jnp.array([[30.0, 20.0]])
    end = jnp.array([[60.0, 20.0]])
    res = line_stereo.match(ref_patch, img_cmp, start, end, jnp.ones(1),
                            LineStereoParams(), 34)
    assert int(res.status[0]) == line_stereo.FAIL_MAX_COST


def test_line_stereo_ambiguous_failure():
    """Periodic texture produces two distant near-equal minima -> AMBIGUOUS."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    period = 8.0
    img = (128 + 60 * np.sin(2 * np.pi * xx / period)).astype(np.float32)
    img_cmp = jnp.asarray(img)
    x0, y0 = 64.0, 40.0
    ref_patch = jnp.asarray(_patch_at(
        lambda x, y: 128 + 60 * np.sin(2 * np.pi * x / period), x0, y0))[None]
    # Search covering 3 periods -> multiple near-identical minima. Offset by
    # a half-step so the sampled minima have nonzero (hence comparable) cost;
    # perfectly-zero minima defeat the ratio test (as in the reference).
    start = jnp.array([[x0 - 12.45, y0]])
    end = jnp.array([[x0 + 11.55, y0]])
    res = line_stereo.match(ref_patch, img_cmp, start, end, jnp.ones(1),
                            LineStereoParams(), 34)
    assert int(res.status[0]) == line_stereo.FAIL_AMBIGUOUS_MATCH


def test_line_stereo_batched_mixed(rng):
    """Batch of features with different outcomes processes independently."""
    idepth = 0.15
    img_ref, img_cmp, disp = make_pair(idepth)
    xs = np.array([40.0, 60.0, 80.0, 100.0])
    ys = np.array([30.0, 45.0, 60.0, 75.0])
    patches = np.stack([_patch_at(texture, x, y) for x, y in zip(xs, ys)])
    true_x = xs - disp
    start = jnp.asarray(np.stack([true_x - 7, ys], axis=1).astype(np.float32))
    end = jnp.asarray(np.stack([true_x + 7, ys], axis=1).astype(np.float32))
    res = line_stereo.match(jnp.asarray(patches), img_cmp, start, end,
                            jnp.ones(4), LineStereoParams(), 34)
    assert np.all(np.asarray(res.status) == line_stereo.SUCCESS)
    np.testing.assert_allclose(np.asarray(res.u_cmp)[:, 0], true_x, atol=0.3)


# ---------------------------------------------------------------------------
# inverse_depth_filter
# ---------------------------------------------------------------------------


def test_predict_pure_translation():
    """Forward motion toward scene: idepth grows, variance inflates by
    (mu'/mu)^4 * factor."""
    K, Kinv, _ = stereo_geo()
    # Move cmp camera 1m forward (+z).
    T_ref = (se3.quat_identity(), jnp.zeros(3))
    T_cmp = (se3.quat_identity(), jnp.array([0.0, 0.0, 1.0]))
    geo = epipolar.load_relative(K, Kinv, T_ref, T_cmp)

    u_ref = jnp.array([[W / 2.0, H / 2.0]])  # on optical axis
    mu = jnp.array([0.25])  # depth 4 -> new depth 3 -> idepth 1/3
    var = jnp.array([0.01])
    ok, u_cmp, mu_pred, var_pred = idfilter.predict(geo, 1.01, u_ref, mu, var)
    assert bool(ok[0])
    np.testing.assert_allclose(float(mu_pred[0]), 1.0 / 3.0, rtol=1e-5)
    expected_var = 1.01 * (float(mu_pred[0]) / 0.25) ** 4 * 0.01
    np.testing.assert_allclose(float(var_pred[0]), expected_var, rtol=1e-4)


def test_predict_behind_camera():
    K, Kinv, _ = stereo_geo()
    T_ref = (se3.quat_identity(), jnp.zeros(3))
    T_cmp = (se3.quat_identity(), jnp.array([0.0, 0.0, 5.0]))  # 5m forward
    geo = epipolar.load_relative(K, Kinv, T_ref, T_cmp)
    u_ref = jnp.array([[W / 2.0, H / 2.0]])
    ok, _, mu_pred, var_pred = idfilter.predict(
        geo, 1.01, u_ref, jnp.array([0.5]), jnp.array([0.01]))  # depth 2 < 5
    assert not bool(ok[0])
    assert float(mu_pred[0]) == 0.0
    assert float(var_pred[0]) == 1e10


def test_search_region_centered_on_prior():
    _, _, geo = stereo_geo()
    params = FilterParams()
    u_ref = jnp.array([[80.0, 48.0]])
    mu, var = jnp.array([0.2]), jnp.array([0.0004])  # sigma=0.02
    reg = idfilter.get_search_region(params, geo, W, H, u_ref, mu, var)
    assert bool(reg.ok[0])
    # Expected: projections at idepth 0.2 -/+ 2*0.02.
    lo, _ = epipolar.project_idepth(geo, u_ref, jnp.array([0.2 - 0.04]))
    hi, _ = epipolar.project_idepth(geo, u_ref, jnp.array([0.2 + 0.04]))
    np.testing.assert_allclose(np.asarray(reg.start[0]), np.asarray(lo[0]),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(reg.end[0]), np.asarray(hi[0]),
                               atol=1e-3)
    # Direction along -x (disparity grows leftward for +x baseline).
    assert float(reg.epi[0, 0]) < 0


def test_search_region_min_length_padding():
    _, _, geo = stereo_geo()
    params = FilterParams()
    u_ref = jnp.array([[80.0, 48.0]])
    mu, var = jnp.array([0.2]), jnp.array([1e-8])  # tiny sigma -> tiny segment
    reg = idfilter.get_search_region(params, geo, W, H, u_ref, mu, var)
    assert bool(reg.ok[0])
    seg = np.asarray(reg.end[0] - reg.start[0])
    np.testing.assert_allclose(np.linalg.norm(seg), params.epilength_min,
                               rtol=1e-3)


def test_search_region_max_length_clamp():
    _, _, geo = stereo_geo()
    params = FilterParams()
    u_ref = jnp.array([[110.0, 48.0]])
    mu, var = jnp.array([0.5]), jnp.array([4.0])  # huge sigma
    reg = idfilter.get_search_region(params, geo, W, H, u_ref, mu, var)
    assert bool(reg.ok[0])
    seg = np.asarray(reg.end[0] - reg.start[0])
    assert np.linalg.norm(seg) <= params.epilength_max + 1e-3


def test_update_fusion_and_gate():
    # Standard Gaussian fusion.
    ok, mu, var = idfilter.update(jnp.array([0.2]), jnp.array([0.01]),
                                  jnp.array([0.3]), jnp.array([0.02]),
                                  outlier_sigma_thresh=3.0)
    w = 0.01 + 0.02
    np.testing.assert_allclose(float(mu[0]), (0.02 * 0.2 + 0.01 * 0.3) / w,
                               rtol=1e-5)
    np.testing.assert_allclose(float(var[0]), 0.01 * 0.02 / w, rtol=1e-5)
    assert bool(ok[0])

    # Outlier: measurement 10 sigma away -> gated.
    ok, _, _ = idfilter.update(jnp.array([0.2]), jnp.array([0.0001]),
                               jnp.array([0.5]), jnp.array([0.0001]),
                               outlier_sigma_thresh=2.0)
    assert not bool(ok[0])

    # First detection: invalid prediction takes the measurement.
    ok, mu, var = idfilter.update(jnp.array([0.0]), jnp.array([1e10]),
                                  jnp.array([0.4]), jnp.array([0.02]))
    np.testing.assert_allclose(float(mu[0]), 0.4, rtol=1e-6)
    np.testing.assert_allclose(float(var[0]), 0.02, rtol=1e-6)


# ---------------------------------------------------------------------------
# Measurement model.
# ---------------------------------------------------------------------------


def test_meas_model_recovers_idepth():
    idepth = 0.25
    K, Kinv, geo = stereo_geo()
    img_ref, img_cmp, disp = make_pair(idepth)
    gx, gy = gradients.central_gradient(img_cmp)

    x0, y0 = 80.0, 48.0
    u_ref = jnp.array([[x0, y0]])
    u_cmp = jnp.array([[x0 - disp, y0]])
    ok, mu, var = meas_model.idepth_measurement(
        MeasModelParams(), geo, gx, gy, u_ref, u_cmp)
    assert bool(ok[0])
    np.testing.assert_allclose(float(mu[0]), idepth, rtol=1e-3)
    assert 0 < float(var[0]) < 1.0


def test_meas_model_variance_formula_rectified():
    """For epi = (-1, 0) and known gradient, check the noise model closed
    form: var = alpha^2 * (elv/(epi.n)^2 + 2 pv/(epi.g)^2) with
    alpha = d(idepth)/d(disp) = 1/(fx*b)."""
    idepth = 0.25
    K, Kinv, geo = stereo_geo()
    img_ref, img_cmp, disp = make_pair(idepth)
    gx, gy = gradients.central_gradient(img_cmp)
    params = MeasModelParams()

    x0, y0 = 80.0, 48.0
    u_ref = jnp.array([[x0, y0]])
    u_cmp = jnp.array([[x0 - disp, y0]])
    ok, mu, var = meas_model.idepth_measurement(
        params, geo, gx, gy, u_ref, u_cmp)

    from flame_tpu.ops import interp
    gxv = float(interp.bilinear(gx, u_cmp[:, 0], u_cmp[:, 1])[0])
    gyv = float(interp.bilinear(gy, u_cmp[:, 0], u_cmp[:, 1])[0])
    gn = np.hypot(gxv, gyv)
    edn = -gxv / gn  # epi = (-1, 0)
    edg = -gxv
    geo_var = params.epipolar_line_var / edn ** 2
    photo_var = 2 * params.pixel_var / edg ** 2
    alpha = 1.0 / (FX * BASELINE)
    want = alpha ** 2 * (geo_var + photo_var)
    np.testing.assert_allclose(float(var[0]), want, rtol=1e-2)


def test_meas_model_negative_disparity_rejected():
    K, Kinv, geo = stereo_geo()
    img_ref, img_cmp, _ = make_pair(0.25)
    gx, gy = gradients.central_gradient(img_cmp)
    u_ref = jnp.array([[80.0, 48.0]])
    u_cmp = jnp.array([[85.0, 48.0]])  # wrong side -> negative disparity
    ok, mu, var = meas_model.idepth_measurement(
        MeasModelParams(), geo, gx, gy, u_ref, u_cmp)
    assert not bool(ok[0])
    assert float(mu[0]) == 0.0 and float(var[0]) == 1e10


# ---------------------------------------------------------------------------
# End-to-end single-feature slice (the PR1 minimum slice): predict ->
# search region -> line search -> measurement -> fusion.
# ---------------------------------------------------------------------------


def test_filter_pipeline_end_to_end():
    idepth_true = 0.22
    K, Kinv, geo = stereo_geo()
    img_ref, img_cmp, disp = make_pair(idepth_true)
    gx, gy = gradients.central_gradient(img_cmp)
    params = FilterParams()

    u_ref = jnp.array([[80.0, 48.0], [60.0, 30.0], [100.0, 70.0]])
    N = u_ref.shape[0]
    mu = jnp.full((N,), 0.25)  # biased prior
    var = jnp.full((N,), 0.003)

    ok_p, u_cmp_pred, mu_pred, var_pred = idfilter.predict(
        geo, params.process_var_factor, u_ref, mu, var)
    assert bool(jnp.all(ok_p))

    reg = idfilter.get_search_region(params, geo, W, H, u_ref, mu, var)
    assert bool(jnp.all(reg.ok))

    res = idfilter.search(params, geo, jnp.ones(N), img_ref, img_cmp,
                          u_ref, u_ref, reg.start, reg.end,
                          line_stereo.n_steps_for(params.epilength_max))
    assert np.all(np.asarray(res.status) == idfilter.SUCCESS)

    ok_m, mu_meas, var_meas = meas_model.idepth_measurement(
        MeasModelParams(), geo, gx, gy, u_ref, res.u_cmp)
    assert bool(jnp.all(ok_m))
    np.testing.assert_allclose(np.asarray(mu_meas), idepth_true, atol=0.01)

    ok_f, mu_post, var_post = idfilter.update(mu_pred, var_pred,
                                              mu_meas, var_meas, 3.0)
    assert bool(jnp.all(ok_f))
    # Posterior pulled toward truth, variance reduced.
    post = np.asarray(mu_post)
    assert np.all(np.abs(post - idepth_true) < np.abs(0.25 - idepth_true))
    assert np.all(np.asarray(var_post) < np.asarray(var_pred))


def test_update_accepts_invalid_prior():
    """Reference chi^2 semantics (inverse_depth_filter.cc:283-294):
    reject only when dist > thresh^2 — a NaN/first-detection prior makes
    that comparison false, so the raw measurement is ACCEPTED. `dist <=
    thresh` would invert this for NaN (r3 review finding)."""
    from flame_tpu.stereo import filter as idfilter
    ok, mu, var = idfilter.update(
        jnp.array([jnp.nan, 0.0, 0.2]), jnp.array([jnp.nan, 1e10, 0.01]),
        jnp.array([0.5, 0.5, 0.21]), jnp.array([0.01, 0.01, 0.01]), 3.0)
    assert bool(ok[0]) and float(mu[0]) == 0.5  # NaN prior: accepted raw
    assert bool(ok[1]) and float(mu[1]) == 0.5  # <=0 prior: accepted raw
    assert bool(ok[2])  # consistent fusion
    # A genuinely inconsistent measurement still rejects.
    ok2, _, _ = idfilter.update(
        jnp.array([0.2]), jnp.array([1e-6]), jnp.array([0.9]),
        jnp.array([0.01]), 3.0)
    assert not bool(ok2[0])


def test_n_steps_for_respects_sample_dist():
    from flame_tpu.stereo import line_stereo
    assert line_stereo.n_steps_for(32.0) == 34  # default spacing: as before
    assert line_stereo.n_steps_for(32.0, 0.5) == 66
    assert line_stereo.n_steps_for(32.0, 2.0) == 18
