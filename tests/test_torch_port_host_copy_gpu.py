"""The frames' way from the card to the host, on the card at the widths
of the paper's configuration (B = 32 rows, H = 200, K = 512 codes, 20-frame
chunks, 135-dim poses): `generate_batch` returns each transcript's real
frames as views of one pinned host block; a call's arrays stay as they
were through two more calls on other transcripts, whose every value
differs, so no block is shared;
and the frames gathered and unnormalised on the card equal bitwise the
old path's (`unnormalize` over the padded frames copied to the host,
sliced after), with fp32 and float64 statistics. Run on the card with
`python3 -m pytest -m gpu tests/test_torch_port_host_copy_gpu.py`."""
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.data.datasets import unnormalize
from gesture2vec_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

B, S, H, K, L, WORDS, POSE = 32, 48, 200, 512, 2, 100, 135


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the frames are copied to pinned "
                    "host memory only from one")
    return torch.device("cuda")


def _generator(device, stats_dtype=np.float32):
    from gesture2vec_tpu_torch.infer.text2gesture import GestureGenerator
    from gesture2vec_tpu_torch.models.dae import DAE
    from gesture2vec_tpu_torch.models.seq_ae import SeqDecoder
    from gesture2vec_tpu_torch.models.text2token import Text2Token
    from gesture2vec_tpu_torch.text.vocab import Vocab

    torch.manual_seed(0)
    t2t = Text2Token(n_words=WORDS, n_tokens=K, hidden_size=H, n_layers=L,
                     n_steps=6, n_pre_poses=2, word_embed_size=32,
                     encoder_type="tcn", use_attention=True)
    seq = SeqDecoder(40, H, L, 20, K, n_pre_poses=1, conditioned=True)
    vocab = Vocab("host_copy")
    for i in range(WORDS - 4):
        vocab.index_word(f"w{i}")
    rng = np.random.default_rng(7)
    std = rng.uniform(0.001, 2.0, POSE).astype(stats_dtype)
    std[0] = 0.0                                   # clipped to 0.01
    return GestureGenerator(
        t2t_model=t2t, seq_decoder=seq, dae_model=DAE(POSE, 40), vocab=vocab,
        pose_mean=rng.normal(0.0, 3.0, POSE).astype(stats_dtype),
        pose_std=std, n_frames=20, sentence_frame_length=120, fps=20,
        max_words=S, mode="decode", use_fused_decoder=False, device=device)


def _batch(seed):
    """B transcripts of 6-120 s (1-20 windows, a bucket of 32)."""
    rng = np.random.default_rng(seed)
    durs = [float(d) for d in np.geomspace(6.0, 120.0, B)]
    return [[[f"w{rng.integers(WORDS - 4)}", t, t + 0.3]
             for t in np.arange(0.0, d, 0.4)] for d in durs], durs


def _observe(gen):
    """Keeps the DAE's padded frames of each call, on the card."""
    seen = []
    decode = gen.dae_model.decode

    def observed(latents):
        out = decode(latents)
        seen.append(out)
        return out

    gen.dae_model.decode = observed
    return seen


def _owner(a):
    while isinstance(a, np.ndarray):
        a = a.base
    return a


def _same_bits(got, want):
    return got.dtype == want.dtype and got.shape == want.shape and \
        got.tobytes() == want.tobytes()


@pytest.mark.parametrize("stats_dtype", [np.float32, np.float64])
def test_the_real_frames_land_pinned_as_the_old_path_gave_them(
        card, stats_dtype):
    gen = _generator(card, stats_dtype)
    seen = _observe(gen)
    words, durs = _batch(1)
    before = profiling.counters()
    result = gen.generate_batch(words, durs)
    (padded,) = seen
    old = unnormalize(padded.reshape(B, -1, POSE).cpu().numpy(),
                      gen.pose_mean, gen.pose_std)
    owners = {id(_owner(m)) for m, _ in result}
    assert len(owners) == 1
    owner = _owner(result[0][0])
    assert isinstance(owner, torch.Tensor) and owner.is_pinned()
    real = 0
    for b, (motion, tokens) in enumerate(result):
        n = len(tokens) * 20
        assert motion.dtype == stats_dtype
        assert _same_bits(motion, old[b, :n]), b
        real += n
    copied = profiling.counters().get("gen.frames_copied", 0) - \
        before.get("gen.frames_copied", 0)
    returned = profiling.counters().get("gen.frames_returned", 0) - \
        before.get("gen.frames_returned", 0)
    assert copied == returned == real < old.shape[0] * old.shape[1]
    # a caller without row counts: every frame, as before
    whole = gen._frames(padded)
    assert _owner(whole).is_pinned()
    assert _same_bits(whole, unnormalize(padded.cpu().numpy(),
                                         gen.pose_mean, gen.pose_std))


def test_a_calls_frames_stay_through_later_calls(card):
    gen = _generator(card)
    first = gen.generate_batch(*_batch(1))
    kept = [m.copy() for m, _ in first]
    # the later calls' frames differ from the first's in every value
    # (an untrained model's tokens hardly follow its words)
    gen._pose_shift = gen._pose_shift + 1.0
    second = gen.generate_batch(*_batch(2))
    del second                  # its block goes back to the allocator
    third = gen.generate_batch(*_batch(3))
    for b, (motion, _) in enumerate(first):
        assert np.array_equal(motion, kept[b]), b
    for (motion, _), k in zip(third, kept):
        assert not np.equal(motion, k).any()
    assert _owner(first[0][0]) is not _owner(third[0][0])
