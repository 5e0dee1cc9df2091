"""The plain reference against a brute-force DFT in NumPy, and against the
port's CPU path, at a tiny size."""

import numpy as np
import torch

from port_bench import reference as ref

C_0 = ref.C_0
N, THETA = 32, 0.01


def _inputs(seed=3, rows=40, chans=3):
    rng = np.random.default_rng(seed)
    uvw = rng.uniform(-1, 1, (rows, 3)) * [600.0, 600.0, 50.0]
    vis = rng.standard_normal((rows, chans)) \
        + 1j * rng.standard_normal((rows, chans))
    freqs = C_0 * (1 + 0.01 * np.arange(chans))
    image = np.zeros((N, N))
    image[5, 9], image[20, 17], image[16, 16] = 1.0, -0.5, 0.25
    return uvw, vis, freqs, image


def _lmn(il, im):
    l = (il - N // 2) * THETA / N
    m = (im - N // 2) * THETA / N
    return l, m, np.sqrt(1 - l * l - m * m) - 1


def test_predict_matches_brute_force():
    uvw, _, freqs, image = _inputs()
    want = np.zeros((uvw.shape[0], freqs.shape[0]), complex)
    for il in range(N):
        for im in range(N):
            if image[il, im]:
                l, m, n = _lmn(il, im)
                for c, f in enumerate(freqs):
                    u, v, w = (uvw * f / C_0).T
                    want[:, c] += image[il, im] * np.exp(
                        -2j * np.pi * (u * l + v * m + w * n))
    got = ref.predict(torch.as_tensor(uvw), torch.as_tensor(freqs),
                      torch.as_tensor(image), THETA).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # One sample at a time gives the same numbers.
    rows = torch.tensor([0, 7, 39])
    chans = torch.tensor([2, 0, 1])
    at = ref.predict_at(torch.as_tensor(uvw)[rows],
                        torch.as_tensor(freqs)[chans],
                        torch.as_tensor(image), THETA).numpy()
    np.testing.assert_allclose(at, want[rows, chans], rtol=0, atol=1e-12)


def test_dirty_matches_brute_force():
    uvw, vis, freqs, _ = _inputs()
    il = torch.tensor([0, 5, 16, 31])
    im = torch.tensor([3, 16, 16, 30])
    want = []
    for a, b in zip(il.tolist(), im.tolist()):
        l, m, n = _lmn(a, b)
        total = 0.0
        for c, f in enumerate(freqs):
            u, v, w = (uvw * f / C_0).T
            total += (vis[:, c] * np.exp(
                2j * np.pi * (u * l + v * m + w * n))).sum().real
        want.append(total)
    got = ref.dirty(torch.as_tensor(uvw), torch.as_tensor(freqs),
                    torch.as_tensor(vis), il, im, N, THETA).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-10)


def test_blocks_change_nothing(monkeypatch):
    uvw, vis, freqs, image = _inputs()
    args = (torch.as_tensor(uvw), torch.as_tensor(freqs))
    whole = ref.predict(*args, torch.as_tensor(image), THETA)
    monkeypatch.setattr(ref, "BLOCK_ELEMENTS", 7)
    np.testing.assert_allclose(
        ref.predict(*args, torch.as_tensor(image), THETA).numpy(),
        whole.numpy(), rtol=0, atol=1e-13)


def test_relative_error():
    want = torch.tensor([1.0, -4.0, 2.0], dtype=torch.float64)
    got = torch.tensor([1.0, -3.0, 2.0], dtype=torch.float32)
    assert ref.relative_error(got, want) == 0.25


def test_reference_against_the_ports_cpu_path():
    """The port's packed gridder on the CPU agrees with the reference at
    the tolerance of its kernel (support 8) in the well-conditioned box:
    the reference and the port compute the same transforms."""
    from ska_sdp_func_torch.parallel.packed import PackedGridder, \
        plan_packed
    from ska_sdp_func_torch.parallel.wstack import plan_wstack

    n, theta, rows, chans = 256, 0.002, 200, 2
    rng = np.random.default_rng(11)
    uvw = rng.uniform(-1, 1, (rows, 3))
    uvw[:, :2] *= 0.45 * n / 2 / theta
    uvw[:, 2] *= 600.0
    vis = (rng.standard_normal((rows, chans))
           + 1j * rng.standard_normal((rows, chans)))
    f0, df = C_0, C_0 / 6400
    wplan = plan_wstack(uvw, f0, df, chans, n, 128, theta, 100.0,
                        w_tower_height=4.0)
    g = PackedGridder(plan_packed(wplan, uvw), device="cpu")
    image = g.grid(torch.as_tensor(vis.astype(np.complex64))).numpy()
    freqs = torch.as_tensor(f0 + df * np.arange(chans))
    il = torch.arange(n // 2 - 96, n // 2 + 96, 7)
    im = torch.arange(n // 2 + 90, n // 2 - 102, -7)
    want = ref.dirty(torch.as_tensor(uvw), freqs, torch.as_tensor(vis),
                     il, im, n, theta)
    assert ref.relative_error(torch.as_tensor(image)[il, im], want) < 1e-3
    model = np.zeros((n, n), np.float32)
    model[140, 100], model[90, 170] = 1.0, 0.5
    pred = g.degrid(torch.as_tensor(model))
    want = ref.predict(torch.as_tensor(uvw), freqs, torch.as_tensor(model),
                       theta)
    assert ref.relative_error(pred, want) < 1e-3
