"""PyTorch port vs the JAX package: `compat/torch_import`, the importer of
reference PyTorch checkpoints, and `cli/tools import-checkpoint`.

The repo holds no reference checkpoint, so each case writes the
reference's state dict from a JAX-initialised model's variables
(perturbed, so no leaf keeps its initial value) with the inverse map of
`tests/torch_reference_layout.py`, at small widths (hidden 12, 2 layers,
8 codes, 6 frames, pose 10), inputs from numpy seeds, JAX on the CPU:

- every converter of the port returns JAX's tree for the same state
  dict, bit for bit, leaf by leaf;
- the converted tree is the one the state dict was written from (the TCN
  encoder's `hidden_proj`, which the reference lacks, merged back with
  `merge_params` and named);
- models built from the converted trees in both packages agree: tokens
  identical, floats within 1e-5 of the largest magnitude (at least 1);
- `import-checkpoint` writes, from one `.pt` payload, a file that both
  packages' `load_checkpoint_and_model` read back, with the same trees,
  kind, epoch and pose_dim as the JAX command's file.
"""
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.compat import from_jax as fj
from gesture2vec_tpu_torch.compat import torch_import as pti
from tests import torch_reference_layout as R
from tests.test_torch_port_models import perturb

TOL = 1e-5
DIM, REP, HID, L, K, NF = 10, 6, 12, 2, 8, 6
N_WORDS, EMB, MAXW, N_STEPS, B, SR = 30, 10, 8, 3, 5, 16000


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed=4):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, MAXW + 1, B).astype(np.int32)
    ids = rng.integers(4, N_WORDS, (B, MAXW)).astype(np.int32)
    ids[np.arange(MAXW)[None, :] >= lengths[:, None]] = 0
    return {"x": rng.normal(size=(B, DIM)).astype(np.float32),
            "latents": rng.normal(size=(B, NF, REP)).astype(np.float32),
            "ids": ids, "lengths": lengths,
            "targets": rng.integers(0, K, (B, N_STEPS)).astype(np.int32),
            "poses": rng.normal(size=(B, NF, DIM)).astype(np.float32),
            "clusters": rng.integers(0, K, B).astype(np.int32),
            "mel": rng.normal(size=(2, 2, 128, 32)).astype(np.float32),
            "wav": (0.3 * rng.normal(size=(2, SR))).astype(np.float32)}


def flat(tree, prefix=()):
    """{path: leaf} of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, prefix + (k,)))
    return out


def assert_same_tree(got, want):
    """The same paths, and every leaf with the same dtype, shape and
    bits."""
    got, want = flat(got), flat(want)
    assert sorted(got, key=str) == sorted(want, key=str)
    for path, w in want.items():
        g = got[path]
        if isinstance(w, (int, str)) and not isinstance(w, bool):
            assert g == w, path
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1.0)
    assert err <= TOL, err


# -- the cases: (JAX model, variables, state dict, converter, kwargs) ---------
_CASES = {}


def _vars_of(module, *args, rng_seed=0):
    import jax
    v = _np(module.init(jax.random.PRNGKey(0), *args))
    return perturb(v, np.random.default_rng(rng_seed), 0.3)


def case(name):
    """{"module", "variables", "sd", "convert", "kw", "expected",
    "missing"} for a case, built once."""
    if name in _CASES:
        return _CASES[name]
    import jax
    import jax.numpy as jnp

    from gesture2vec_tpu.models import audio as jaudio
    from gesture2vec_tpu.models.baseline import Seq2SeqNet
    from gesture2vec_tpu.models.c2g import Cluster2Gesture
    from gesture2vec_tpu.models.dae import DAE, VQFrame
    from gesture2vec_tpu.models.seq_ae import SeqVQAutoencoder
    from gesture2vec_tpu.models.text2token import Text2Token
    from gesture2vec_tpu.models.vq import init_ema_state

    x = {k: jnp.asarray(v) for k, v in _inputs().items()}
    missing = set()
    if name == "dae":
        m = DAE(motion_dim=DIM, latent_dim=REP)
        v = _vars_of(m, x["x"])
        sd, conv, kw = R.dae_sd(v["params"]), "convert_dae_state", {}
        expected = v["params"]
    elif name.startswith("vq_frame"):
        m = VQFrame(motion_dim=DIM, latent_dim=REP, vq_components=K,
                    vae=name == "vq_frame_vae")
        vq0 = init_ema_state(jax.random.PRNGKey(1), K, REP)
        v = _vars_of(m, x["x"], vq0)
        rng = np.random.default_rng(5)
        vq = {"codebook": rng.normal(size=(K, REP)).astype(np.float32),
              "cluster_size": rng.random(K).astype(np.float32) + 0.5,
              "ema_w": rng.normal(size=(K, REP)).astype(np.float32)}
        v["vq_state"] = vq
        sd = R.vq_frame_sd(v["params"], v["batch_stats"], vq)
        conv, kw = "convert_vq_frame_state", {}
        expected = (v["params"], v["batch_stats"], vq)
    elif name.startswith("seq_ae"):
        m = SeqVQAutoencoder(rep_dim=REP, hidden_size=HID, n_layers=L,
                             n_frames=NF, vq_components=K,
                             use_attention=name == "seq_ae_att")
        v = _vars_of(m, x["latents"], x["latents"])
        sd = R.seq_ae_sd(v["params"], v["batch_stats"], L)
        conv, kw = "convert_seq_ae_state", {"n_layers": L}
        expected = (v["params"], v["batch_stats"])
    elif name.startswith("t2t") or name == "tcn":
        enc = "tcn" if name == "tcn" else "gru"
        m = Text2Token(n_words=N_WORDS, n_tokens=K, hidden_size=HID,
                       n_layers=L, n_steps=N_STEPS, n_pre_poses=2,
                       word_embed_size=EMB, encoder_type=enc,
                       use_attention=name != "t2t_gru")
        v = _vars_of(m, x["ids"], x["lengths"], x["targets"])
        if name == "tcn":
            sd = R.tcn_encoder_sd(v["params"]["encoder"], L)
            conv, kw = "convert_tcn_encoder_state", {"n_layers": L}
            expected = {k: t for k, t in v["params"]["encoder"].items()
                        if k != "hidden_proj"}
            missing = {("hidden_proj", "bias"), ("hidden_proj", "kernel")}
        else:
            sd = R.text2token_sd(v["params"], v["batch_stats"], L)
            conv, kw = "convert_text2token_state", {"n_layers": L}
            expected = (v["params"], v["batch_stats"])
    elif name == "baseline":
        m = Seq2SeqNet(n_words=N_WORDS, pose_dim=DIM, n_frames=NF,
                       hidden_size=HID, n_layers=L, n_pre_poses=2,
                       word_embed_size=EMB)
        v = _vars_of(m, x["ids"], x["lengths"], x["poses"])
        sd = R.baseline_sd(v["params"], v["batch_stats"], L)
        conv, kw = "convert_baseline_state", {"n_layers": L}
        expected = (v["params"], v["batch_stats"])
    elif name == "c2g":
        m = Cluster2Gesture(n_clusters=K, output_size=REP, hidden_size=HID,
                            n_frames=NF, n_layers=1)
        v = _vars_of(m, x["clusters"])
        sd = R.c2g_sd(v["params"], v["batch_stats"], 1)
        conv, kw = "convert_c2g_state", {"n_layers": 1}
        expected = (v["params"], v["batch_stats"])
    elif name == "audio_encoder":
        m = jaudio.AudioContextEncoder(hidden_size=HID, n_layers=L)
        v = _vars_of(m, x["mel"])
        sd = R.audio_encoder_sd(v["params"], v["batch_stats"], L)
        conv, kw = "convert_audio_encoder_state", {"n_layers": L}
        expected = (v["params"], v["batch_stats"])
    elif name == "wav_tri":
        m = jaudio.WavEncoderTri(out_dim=HID)
        v = perturb(_np(m.init(jax.random.PRNGKey(0), x["wav"])),
                    np.random.default_rng(0), 0.05)
        sd = R.wav_encoder_tri_sd(v["params"], v["batch_stats"])
        conv, kw = "convert_wav_encoder_tri_state", {}
        expected = (v["params"], v["batch_stats"])
    else:
        raise KeyError(name)
    _CASES[name] = {"module": m, "variables": v, "sd": sd, "convert": conv,
                    "kw": kw, "expected": expected, "missing": missing}
    return _CASES[name]


CASE_NAMES = ("dae", "vq_frame", "vq_frame_vae", "seq_ae", "seq_ae_att",
              "t2t_gru", "t2t_gru_att", "tcn", "baseline", "c2g",
              "audio_encoder", "wav_tri")


def _variables(name, converted, base):
    """The converted tree as model variables ({"params", "batch_stats"},
    with "vq_state" for the frame model; the TCN encoder's tree, merged
    over the model's own, in the model's params)."""
    if name == "dae":
        return {"params": converted}
    if name.startswith("vq_frame"):
        p, s, vq = converted
        return {"params": p, "batch_stats": s, "vq_state": vq}
    if name == "tcn":
        return {"params": {**base["params"], "encoder": converted},
                "batch_stats": base["batch_stats"]}
    p, s = converted
    return {"params": p, "batch_stats": s}


def run_jax(name, v):
    """{output: array} of the JAX model in eval mode."""
    import jax.numpy as jnp
    from gesture2vec_tpu.models.vq import VQEmaState

    m = case(name)["module"]
    x = {k: jnp.asarray(a) for k, a in _inputs(9).items()}
    if name == "dae":
        return {"output": m.apply(v, x["x"], train=False)}
    if name.startswith("vq_frame"):
        res, _ = m.apply({"params": v["params"],
                          "batch_stats": v["batch_stats"]}, x["x"],
                         VQEmaState(**v["vq_state"]), train=False)
        return {"output": res["output"],
                "tokens": jnp.argmax(res["vq"].encodings, -1)}
    if name.startswith("seq_ae"):
        res = m.apply(v, x["latents"], x["latents"], train=False)
        return {"output": res["outputs"],
                "tokens": jnp.argmax(res["vq"].encodings, -1)}
    if name.startswith("t2t") or name == "tcn":
        res = m.apply(v, x["ids"], x["lengths"], x["targets"], train=False)
        return {"logits": res["logits"], "tokens": res["tokens"]}
    if name == "baseline":
        return {"output": m.apply(v, x["ids"], x["lengths"], x["poses"],
                                  train=False)["outputs"]}
    if name == "c2g":
        return {"output": m.apply(v, x["clusters"], train=False)}
    out = m.apply(v, x["mel" if name == "audio_encoder" else "wav"],
                  train=False)
    return dict(enumerate(out)) if isinstance(out, tuple) \
        else {"output": out}


@torch.no_grad()
def run_port(name, v):
    """{output: array} of the port's model, built from v, in eval mode."""
    from gesture2vec_tpu_torch.models import audio as paudio

    x = {k: torch.from_numpy(a) for k, a in _inputs(9).items()}
    ids, lens = x["ids"].long(), x["lengths"].long()
    if name == "dae":
        return {"output": fj.dae_from_jax(v, motion_dim=DIM,
                                          latent_dim=REP)(x["x"])}
    if name.startswith("vq_frame"):
        m = fj.frame_model_from_jax(v, motion_dim=DIM, latent_dim=REP,
                                    vq_components=K,
                                    vae=name == "vq_frame_vae",
                                    vq_state=v["vq_state"])
        res = m(x["x"])
        return {"output": res["output"],
                "tokens": res["vq"].encodings.argmax(-1)}
    if name.startswith("seq_ae"):
        res = fj.seq_ae_from_jax(v, n_frames=NF, n_pre_poses=1)(
            x["latents"], x["latents"])
        return {"output": res["outputs"],
                "tokens": res["vq"].encodings.argmax(-1)}
    if name.startswith("t2t") or name == "tcn":
        res = fj.text2token_from_jax(v, n_steps=N_STEPS, n_pre_poses=2)(
            ids, lens, x["targets"].long())
        return {"logits": res["logits"], "tokens": res["tokens"]}
    if name == "baseline":
        m = fj.baseline_from_jax(v, n_frames=NF, n_pre_poses=2)
        return {"output": m(ids, lens, x["poses"])["outputs"]}
    if name == "c2g":
        return {"output": fj.c2g_from_jax(v, n_frames=NF)(
            x["clusters"].long())}
    if name == "audio_encoder":
        m, inp = paudio.AudioContextEncoder(HID, n_layers=L), x["mel"]
    else:
        m, inp = paudio.WavEncoderTri(HID), x["wav"]
    fj.load_jax_variables(m, v["params"], v["batch_stats"])
    out = m.eval()(inp)
    return dict(enumerate(out)) if isinstance(out, tuple) \
        else {"output": out}


@pytest.mark.parametrize("name", CASE_NAMES)
def test_converter_matches_jax(name):
    """The port's converter returns JAX's tree for the same reference
    state dict, bit for bit; that tree is the one the state dict was
    written from (the reference lacks only the leaves named in
    `missing`, which `merge_params` keeps from the base); and the models
    built from the two packages' trees agree."""
    from gesture2vec_tpu.compat import torch_import as jti

    c = case(name)
    want = getattr(jti, c["convert"])(c["sd"], **c["kw"])
    got = getattr(pti, c["convert"])(c["sd"], **c["kw"])
    assert_same_tree(got, want)
    if c["missing"]:
        base = c["variables"]["params"]["encoder"]
        assert set(flat(base)) - set(flat(got)) == c["missing"]
        assert_same_tree(got, c["expected"])
        assert_same_tree(pti.merge_params(base, got), base)
        want, got = jti.merge_params(base, want), \
            pti.merge_params(base, got)
        assert_same_tree(got, want)
    else:
        assert_same_tree(got, c["expected"])
    j = run_jax(name, _variables(name, want, c["variables"]))
    p = run_port(name, _variables(name, got, c["variables"]))
    assert sorted(j) == sorted(p)
    for key, w in j.items():
        g = p[key].numpy()
        if key == "tokens":
            np.testing.assert_array_equal(g, np.asarray(w))
        else:
            close(g, w)


def test_merge_params_keeps_unmatched_leaves():
    """merge_params: a deep merge that overwrites matched leaves and keeps
    the base's others, as JAX's."""
    from gesture2vec_tpu.compat import torch_import as jti

    base = {"a": {"k": np.zeros(2), "keep": np.ones(1)}, "b": np.ones(3),
            "c": 1}
    update = {"a": {"k": np.full(2, 5.0)}, "b": {"x": np.zeros(1)},
              "d": np.ones(1)}
    got = pti.merge_params(base, update)
    assert_same_tree(got, jti.merge_params(base, update))
    assert_same_tree(got, {"a": {"k": np.full(2, 5.0), "keep": np.ones(1)},
                           "b": {"x": np.zeros(1)}, "c": 1,
                           "d": np.ones(1)})
    assert base["a"]["k"].sum() == 0  # the base is not written to


# -- reference checkpoint files ------------------------------------------------
KIND_CASES = {"DAE": ("dae", dict(name="d", model="DAE", hidden_size=REP,
                                  input_motion_dim=DIM)),
              "autoencoder_vq": ("seq_ae", dict(
                  name="s", model="seq2seq", hidden_size=HID, n_layers=L,
                  rep_learning_dim=REP, n_poses=NF, n_pre_poses=1,
                  autoencoder_vq=True, autoencoder_vq_components=K)),
              "autoencoder": ("seq_ae_att", dict(
                  name="s", model="seq2seq", hidden_size=HID, n_layers=L,
                  rep_learning_dim=REP, n_poses=NF, n_pre_poses=1,
                  autoencoder_vq=True, autoencoder_vq_components=K,
                  autoencoder_att=True)),
              "text2embedding": ("t2t_gru_att", dict(
                  name="t", model="seq2seq", hidden_size=HID, n_layers=L,
                  n_poses=NF, n_pre_poses=2, sentence_frame_length=NF
                  * N_STEPS, autoencoder_vq_components=K,
                  autoencoder_att=True, wordembed_dim=EMB,
                  text_encoder="gru"))}


def write_reference_file(path, kind, epoch=7):
    """A reference .pt payload of the kind's case: {args (a Namespace
    with the reference's string booleans), epoch, pose_dim, gen_dict}."""
    name, cfg = KIND_CASES[kind]
    torch.save(R.reference_payload(case(name)["sd"], R.reference_args(cfg),
                                   epoch=epoch, pose_dim=DIM), path)
    return name


@pytest.mark.parametrize("kind", sorted(KIND_CASES))
def test_import_checkpoint_loads_in_both_packages(kind, tmp_path):
    """`import-checkpoint` (the port's command, through main) and JAX's
    `import_reference_checkpoint` on one reference payload: the two files
    hold the same trees, kind, epoch and pose_dim; each loads in both
    packages' `load_checkpoint_and_model`, and the models agree with the
    JAX model of the case (tokens identical, floats within 1e-5)."""
    from gesture2vec_tpu.cli.tools import import_reference_checkpoint
    from gesture2vec_tpu.train import checkpoints as jckpt

    from gesture2vec_tpu_torch.cli import tools
    from gesture2vec_tpu_torch.compat import checkpoint as pckpt

    pt = str(tmp_path / "ref.pt")
    name = write_reference_file(pt, kind)
    got_path, want_path = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    assert tools.main(["import-checkpoint", pt, got_path, "--kind",
                       kind]) is None
    import_reference_checkpoint(pt, want_path, kind)
    got, want = pckpt.load_checkpoint(got_path), \
        pckpt.load_checkpoint(want_path)
    for key in ("kind", "epoch", "pose_dim", "lang_model"):
        assert got[key] == want[key]
    assert (got["kind"], got["epoch"], got["pose_dim"]) == (kind, 7, DIM)
    assert_same_tree(got["params"], want["params"])
    assert_same_tree(got["extra"], want["extra"])
    assert got["config"] == want["config"]
    ref = run_jax(name, case(name)["variables"])
    for path in (got_path, want_path):
        jm, jv, payload = jckpt.load_checkpoint_and_model(path, kind)
        assert payload["kind"] == kind and payload["epoch"] == 7
        pm, payload = pckpt.load_checkpoint_and_model(path, kind, "cpu")
        assert payload["kind"] == kind and payload["pose_dim"] == DIM
        j, p = _run_loaded(name, jm, jv, pm)
        for key in j:
            if key == "tokens":
                np.testing.assert_array_equal(p[key], j[key])
                np.testing.assert_array_equal(j[key], ref[key])
            else:
                close(p[key], j[key])
                close(j[key], ref[key])


@torch.no_grad()
def _run_loaded(name, jm, jv, pm):
    """The loaded JAX model (module, variables) and the loaded port model
    on the case's inputs."""
    import jax.numpy as jnp

    x = _inputs(9)
    jx = {k: jnp.asarray(a) for k, a in x.items()}
    t = {k: torch.from_numpy(a) for k, a in x.items()}
    if name == "dae":
        return ({"output": np.asarray(jm.apply(jv, jx["x"], train=False))},
                {"output": pm(t["x"]).numpy()})
    if name.startswith("seq_ae"):
        r = jm.apply(jv, jx["latents"], jx["latents"], train=False)
        q = pm(t["latents"], t["latents"])
        return ({"output": np.asarray(r["outputs"]), "tokens": np.asarray(
                    jnp.argmax(r["vq"].encodings, -1))},
                {"output": q["outputs"].numpy(),
                 "tokens": q["vq"].encodings.argmax(-1).numpy()})
    r = jm.apply(jv, jx["ids"], jx["lengths"], jx["targets"], train=False)
    q = pm(t["ids"].long(), t["lengths"].long(), t["targets"].long())
    return ({"logits": np.asarray(r["logits"]),
             "tokens": np.asarray(r["tokens"])},
            {"logits": q["logits"].numpy(), "tokens": q["tokens"].numpy()})


def test_load_reference_checkpoint_reads_state_dict_payloads(tmp_path):
    """load_reference_checkpoint: {args, epoch, pose_dim, state_dict} with
    numpy leaves from a gen_dict payload, and from a bare state dict (the
    reference's DAE files), as JAX's."""
    from gesture2vec_tpu.compat import torch_import as jti

    sd = case("dae")["sd"]
    for payload in (R.reference_payload(sd, {"hidden_size": REP}, epoch=3,
                                        pose_dim=DIM), dict(sd)):
        path = str(tmp_path / "ref.pt")
        torch.save(payload, path)
        got = pti.load_reference_checkpoint(path)
        want = jti.load_reference_checkpoint(path)
        assert got["epoch"] == want["epoch"]
        assert got["pose_dim"] == want["pose_dim"]
        assert vars(got["args"]) == vars(want["args"]) \
            if got["args"] is not None else want["args"] is None
        assert_same_tree(got["state_dict"], want["state_dict"])
        assert all(isinstance(a, np.ndarray)
                   for a in got["state_dict"].values())
