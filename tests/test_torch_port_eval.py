"""The port's quality-gate harness (rdm_tpu_torch/eval/) against the JAX
package's (rdm_tpu/eval/), on the CPU.

- FID: `frechet_distance` / `fid_from_features` within 1e-9 relative of
  JAX's on seeded Gaussians (both float64 numpy).
- Precision / recall: the manifold radii (squared k-th neighbour
  distances, blocked f32 products on each side) within 1e-5 relative, P
  and R equal, with blocks smaller than the sets.
- The fidelity helpers: `psnr`, `cosine`, `per_step_cosine` and
  `compare_runs` equal to JAX's on the same arrays.
- The micro gate's pieces: `make_shapes`, `pixel_embed`,
  `pixel_stat_features` and `_neighbor_table` bit-equal;
  `features_from_images` equal.
- `train_vq`: JAX's `train_vq` runs with a spy on its `jax.jit` that
  keeps its init and each step's state and loss; the port's starts from
  that init (carried by `vq_state_dict_from_jax`) over the same batch
  indices. Its first two losses hold 1e-4 relative free-running, and each
  of the 5 steps taken from JAX's state holds 1e-4 (see the test for why
  the free-running trajectories part after two steps).
- The gates' mechanics at JAX's toy arguments (tests/test_micro_gate.py):
  finite, positive records with JAX's keys, the report naming the head
  split; the CLI's verdict and its non-zero exit on a failed gate.
"""

import json

import jax
import numpy as np
import pytest
import torch

from rdm_tpu.eval import fidelity as jfid
from rdm_tpu.eval import metrics as jmet
from rdm_tpu.eval import micro_gate as jmg
from rdm_tpu.models.autoencoder import AutoencoderConfig as JAEConfig
from rdm_tpu_torch import config as pc
from rdm_tpu_torch.eval import fidelity as pfid
from rdm_tpu_torch.eval import metrics as pmet
from rdm_tpu_torch.eval import micro_gate as pmg
from rdm_tpu_torch.scripts import micro_quality_gate as cli
from rdm_tpu_torch.utils.from_jax import vq_state_dict_from_jax

# the keys of JAX's gate reports (rdm_tpu/eval/micro_gate.py:247-265,
# :337-353)
GATE_KEYS = ("n_train_images", "vq_steps", "sample_n", "guidance",
             "vq_recon_mse", "fid_trained", "fid_random_init",
             "precision_trained", "precision_random", "recall_trained",
             "recall_random", "fid_ratio", "logdir")


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny models: one intra-op thread, so that the suite's workers do
    not oversubscribe the host's cores (the gates' CPU runs slow down
    many-fold when they do)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,d,scale", [(300, 4, 1.0), (1000, 16, 2.5),
                                       (64, 40, 0.3)])
def test_fid_matches_jax(n, d, scale):
    rng = np.random.default_rng(n + d)
    a = rng.standard_normal((n, d))
    b = scale * rng.standard_normal((n, d)) + 0.7
    want = jmet.fid_from_features(a, b)
    got = pmet.fid_from_features(a, b)
    assert got == pytest.approx(want, rel=1e-9)
    mu1, c1 = pmet.gaussian_stats(a)
    mu2, c2 = pmet.gaussian_stats(b)
    assert pmet.frechet_distance(mu1, c1, mu2, c2) == pytest.approx(
        jmet.frechet_distance(mu1, c1, mu2, c2), rel=1e-9)
    np.testing.assert_array_equal(pmet._sqrtm_psd(c1), jmet._sqrtm_psd(c1))


@pytest.mark.parametrize("case", ["overlap", "shifted", "collapsed"])
def test_precision_recall_matches_jax(case):
    rng = np.random.default_rng(7)
    real = rng.standard_normal((300, 12)).astype(np.float32)
    gen = {"overlap": rng.standard_normal((200, 12)),
           "shifted": rng.standard_normal((200, 12)) + 0.8,
           "collapsed": real[0] + 0.3 * rng.standard_normal((200, 12)),
           }[case].astype(np.float32)
    for feats in (real, gen):
        want = jmet._manifold_radii(feats, 3, block=64)
        got = pmet._manifold_radii(feats, 3, block=64, device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-5)
    want = jmet.precision_recall(real, gen, nhood_size=3, block=64)
    got = pmet.precision_recall(real, gen, nhood_size=3, block=64,
                                device="cpu")
    assert got == want
    rec = pmet.evaluate_features(real, gen, device="cpu")
    assert sorted(rec) == sorted(jmet.evaluate_features(real, gen))


def test_features_from_images_matches_jax():
    imgs = list(pmg.make_shapes(10, size=16, seed=3))
    u8 = [((x + 1) * 127.5).astype(np.uint8) for x in imgs]

    def emb(x):
        return np.asarray(x, np.float32).reshape(len(x), -1)[:, :7]

    for seq in (imgs, u8):
        np.testing.assert_array_equal(
            pmet.features_from_images(seq, emb, batch_size=4),
            jmet.features_from_images(seq, emb, batch_size=4))
    # a tensor-valued embedder gives the same features
    np.testing.assert_array_equal(
        pmet.features_from_images(imgs, lambda x: torch.as_tensor(emb(x)),
                                  batch_size=4),
        jmet.features_from_images(imgs, emb, batch_size=4))


def _run(rng, shape=(2, 4, 4, 3), steps=5):
    z = rng.standard_normal(shape).astype(np.float32)
    return {"z": z,
            "images": rng.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8),
            "traj": rng.standard_normal((steps,) + shape).astype(np.float32)}


def test_fidelity_helpers_match_jax():
    rng = np.random.default_rng(5)
    exact = _run(rng)
    noisy = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(v.dtype)
             if k != "images" else v for k, v in exact.items()}
    other = _run(rng)
    for var in (exact, noisy, other):
        assert pfid.compare_runs(exact, var) == jfid.compare_runs(exact,
                                                                  var)
    no_traj = dict(noisy, traj=None)
    assert pfid.compare_runs(exact, no_traj) == jfid.compare_runs(exact,
                                                                  no_traj)
    a, b = exact["z"], noisy["z"]
    assert pfid.psnr(a, b, 2.0) == jfid.psnr(a, b, 2.0)
    assert pfid.psnr(a, a, 2.0) == float("inf")
    assert pfid.cosine(a, b) == jfid.cosine(a, b)
    np.testing.assert_array_equal(
        pfid.per_step_cosine(exact["traj"], noisy["traj"]),
        jfid.per_step_cosine(exact["traj"], noisy["traj"]))


@pytest.mark.parametrize("size,seed", [(16, 0), (32, 4)])
def test_micro_gate_pieces_bit_equal(size, seed):
    imgs = pmg.make_shapes(40, size=size, seed=seed)
    np.testing.assert_array_equal(imgs, jmg.make_shapes(40, size=size,
                                                        seed=seed))
    emb = pmg.pixel_embed(imgs)
    np.testing.assert_array_equal(emb, jmg.pixel_embed(imgs))
    for x in (imgs, ((imgs + 1) * 127.5).astype(np.uint8)):
        np.testing.assert_array_equal(pmg.pixel_stat_features(x),
                                      jmg.pixel_stat_features(x))
    np.testing.assert_array_equal(pmg._neighbor_table(emb, 3),
                                  jmg._neighbor_table(emb, 3))


AE = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, z_channels=3,
          embed_dim=3, n_embed=128, resolution=16, in_channels=3, out_ch=3)


class _JitSpy:
    """Stands in for `jax` inside rdm_tpu/eval/micro_gate.py: its `jit`
    keeps the output of the jitted init and each train step's inputs
    (params, optimizer state, batch) and outputs (params, optimizer state,
    reconstruction loss)."""

    def __init__(self):
        self.init = None
        self.steps = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)
        name = getattr(fn, "__name__", "")

        def spy(*args):
            out = jitted(*args)
            if name == "init":
                self.init = out
            elif name == "step":
                self.steps.append((args, out))
            return out

        return spy

    @property
    def losses(self):
        return [float(out[2]) for _, out in self.steps]


def _port_adam(vq, opt_state, ae, lr):
    """torch Adam over vq's parameters holding optax.adam's state."""
    opt = pmg.adam(vq.parameters(), lr)
    st = opt_state[0]  # ScaleByAdamState(count, mu, nu)
    if int(st.count):
        mu = vq_state_dict_from_jax(st.mu, ae)
        nu = vq_state_dict_from_jax(st.nu, ae)
        for n, p in vq.named_parameters():
            opt.state[p] = {"step": torch.tensor(float(st.count)),
                            "exp_avg": mu[n].clone(),
                            "exp_avg_sq": nu[n].clone()}
    return opt


def test_train_vq_matches_jax(monkeypatch):
    """Free-running from JAX's init over the same batch indices, the
    port's first two steps' losses hold 1e-4; after that the trajectories
    part: Adam turns the gradient elements that are rounding noise (biases
    before a GroupNorm, the attention's key bias) into steps of up to lr,
    whose sign the two implementations' rounding decides. So each of the
    5 steps is also taken from JAX's parameters and Adam state at that
    step: its loss within 1e-4, and its update equal to optax's within
    1e-3 lr on every element whose gradient is at least 1e-3 of the
    largest (more than 30% of them; the rest is where rounding noise can
    lead)."""
    lr = 2e-3
    images = pmg.make_shapes(48, size=16, seed=0)
    spy = _JitSpy()
    monkeypatch.setattr(jmg, "jax", spy)
    _, want_last = jmg.train_vq(images, JAEConfig(**AE), steps=5, batch=8,
                                lr=lr, seed=0)
    assert len(spy.steps) == 5 and spy.losses[-1] == want_last
    ae = pc.AutoencoderConfig(**AE)
    got = []
    sd, last = pmg.train_vq(images, ae, steps=5, batch=8, lr=lr, seed=0,
                            device="cpu",
                            init_state_dict=vq_state_dict_from_jax(
                                spy.init, ae), losses=got)
    np.testing.assert_allclose(got[:2], spy.losses[:2], rtol=1e-4)
    assert last == got[-1] and np.all(np.isfinite(got))
    assert sorted(sd) == sorted(vq_state_dict_from_jax(spy.init, ae))

    from rdm_tpu_torch.models.autoencoder import VQModel

    for (params, opt_state, x), (params_next, _, loss) in spy.steps:
        before = vq_state_dict_from_jax(params, ae)
        want = vq_state_dict_from_jax(params_next, ae)
        vq = VQModel(ae)
        vq.load_state_dict(before)
        opt = _port_adam(vq, opt_state, ae, lr)
        got_loss = pmg.vq_train_step(
            vq, opt, torch.tensor(np.asarray(x)).permute(0, 3, 1, 2))
        assert float(got_loss) == pytest.approx(float(loss), rel=1e-4)
        # the elements whose gradient is well above rounding: the port's
        # Adam step there is optax's within 1e-3 lr
        grads = {n: p.grad.abs() for n, p in vq.named_parameters()}
        gmax = max(float(g.max()) for g in grads.values())
        n_det = n_all = 0
        for n, p in vq.named_parameters():
            det = (grads[n] >= 1e-3 * gmax).numpy()
            dp = (p.detach() - before[n]).numpy()[det]
            dj = (want[n] - before[n]).numpy()[det]
            np.testing.assert_allclose(dp, dj, rtol=0, atol=1e-3 * lr,
                                       err_msg=n)
            n_det += int(det.sum())
            n_all += det.size
        assert n_det > 0.3 * n_all, (n_det, n_all)


def test_vq_forward_is_the_round_trip():
    from rdm_tpu_torch.models.autoencoder import VQModel

    torch.manual_seed(0)
    vq = VQModel(pc.AutoencoderConfig(**AE))
    x = torch.as_tensor(pmg.make_shapes(2, size=16)).permute(0, 3, 1, 2)
    rec, commit, idx = vq(x)
    z_q, commit2, idx2 = vq.encode(x)
    assert torch.equal(rec, vq.decoder(vq.post_quant_conv(z_q)))
    assert torch.equal(commit, commit2) and torch.equal(idx, idx2)
    assert rec.shape == x.shape and idx.shape == (2, 8, 8)
    rec.float().pow(2).mean().backward()  # straight through to the encoder
    assert vq.encoder.conv_in.weight.grad is not None


def _finite_record(report):
    for key in ("fid_trained", "fid_random_init", "precision_trained",
                "recall_trained", "vq_recon_mse", "fid_ratio"):
        assert np.isfinite(report[key]), (key, report)
    assert report["fid_trained"] > 0 and report["fid_random_init"] > 0
    assert set(GATE_KEYS) <= set(report)


def test_run_gate_mechanics(tmp_path):
    report = pmg.run_gate(n_images=48, size=16, k_nn=2, vq_steps=20,
                          rdm_steps=12, train_batch=8, sample_n=16,
                          ddim_steps=4, guidance=1.0, seed=0,
                          logdir=str(tmp_path), device="cpu")
    _finite_record(report)
    assert {"rdm_steps", "ddim_steps"} <= set(report)
    assert (report["num_head_channels"], report["heads"]) == (8, 8)


def test_run_gate_rarm_mechanics(tmp_path):
    report = pmg.run_gate_rarm(n_images=48, size=16, k_nn=2, vq_steps=20,
                               rarm_steps=10, train_batch=8, sample_n=16,
                               top_k=16, guidance=1.0, seed=0,
                               logdir=str(tmp_path), device="cpu")
    _finite_record(report)
    assert report["model"] == "rarm" and {"rarm_steps", "top_k"} <= set(
        report)
    assert (report["heads"], report["head_dim"]) == (4, 16)


def test_cli_verdict_and_exit(tmp_path, monkeypatch, capsys):
    seen = []

    def fake_run(fid_trained):
        def run(**kw):
            seen.append(kw)
            return {"fid_trained": fid_trained, "fid_random_init": 2.0,
                    "precision_trained": 0.9, "precision_random": 0.5}
        return run

    monkeypatch.setattr(pmg, "run_gate_rarm", fake_run(1.8))
    report = cli.gate("rarm", True, device="cuda")
    # the fast tier's steps and the kernels' head split on the card
    assert seen[-1] == {"rarm_steps": cli.FAST_STEPS, "seed": 0,
                        "device": "cuda", "heads": 1, "head_dim": 64}
    assert report["gate_ratio"] == 0.93 and report["passed"]  # 1.8 < 1.86
    monkeypatch.setattr(pmg, "run_gate", fake_run(1.8))
    report = cli.gate("rdm", True, device="cpu", rdm_steps=12)
    assert seen[-1] == {"rdm_steps": 12, "seed": 0, "device": "cpu"}
    assert report["gate_ratio"] == 0.8 and not report["passed"]  # 1.8 > 1.6
    # --split picks the kernels' split on the cpu too
    cli.gate("rarm", False, device="cpu", split="kernels")
    assert seen[-1] == {"seed": 0, "device": "cpu", "heads": 1,
                        "head_dim": 64}

    out = tmp_path / "r.json"
    with pytest.raises(SystemExit, match="GATE FAILED"):
        cli.main(["--model", "rdm", "--fast", "--device", "cpu",
                  "--out", str(out)])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["metric"] == "quality_gate"
    assert json.load(open(out)) == json.loads(last)
