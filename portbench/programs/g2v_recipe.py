"""The recommended recipe under test, built from its configuration and
loaded with the benchmark's weights: the port's transformer Part d with
stage-conditional heads, the 4-stage residual-VQ tokenizer's decoder and
the DAE, through the port's GestureGenerator and nothing else of the
port. The weights are named as the port's modules name their tensors
(`strict` loading: a renamed tensor fails loudly)."""
from portbench.harness import weights as wts
from portbench.programs.g2v import N_SPECIAL


def generator(cfg: dict, weights: dict, seed: int, device):
    """The program under test: GestureGenerator in decode mode,
    window_carry, the chunk-decoder kernel, the configuration's decode
    (a sampled primary token at stage0_temperature, the residual stages
    at temperature)."""
    import torch

    from gesture2vec_tpu_torch.infer.text2gesture import GestureGenerator
    from gesture2vec_tpu_torch.models.dae import DAE
    from gesture2vec_tpu_torch.models.seq_ae import SeqDecoder
    from gesture2vec_tpu_torch.models.transformer import \
        TransformerText2Token
    from gesture2vec_tpu_torch.text.vocab import Vocab

    H, L, K = cfg["hidden_size"], cfg["n_layers"], cfg["codes"]
    n_steps = cfg["sentence_frame_length"] // cfg["n_poses"]
    with torch.device(device):
        t2t = TransformerText2Token(
            n_words=cfg["n_words"], n_tokens=K, hidden_size=H, n_layers=L,
            n_steps=n_steps, n_pre_poses=cfg["t2t_n_pre_poses"],
            word_embed_size=cfg["wordembed_dim"], n_heads=cfg["t2t_heads"],
            token_stages=cfg["token_stages"],
            stage_conditional=cfg["stage_conditional"],
            dropout_rate=cfg["dropout_prob"])
        seq = SeqDecoder(cfg["dae_latent"], H, L, cfg["n_poses"], K,
                         n_pre_poses=1, conditioned=cfg["conditioned"],
                         stages=cfg["tokenizer_stages"])
        dae = DAE(cfg["pose_dim"], cfg["dae_latent"])
    t2t.load_state_dict(wts.group(weights, "t2t"), strict=True)
    seq.load_state_dict(wts.group(weights, "seq"), strict=True)
    dae.load_state_dict(wts.group(weights, "dae"), strict=True)
    vocab = Vocab("portbench")
    for i in range(cfg["n_words"] - N_SPECIAL):
        vocab.index_word(f"w{i}")
    return GestureGenerator(
        t2t_model=t2t, seq_decoder=seq, dae_model=dae, vocab=vocab,
        pose_mean=weights["pose.mean"].cpu().numpy(),
        pose_std=weights["pose.std"].cpu().numpy(),
        n_frames=cfg["n_poses"],
        sentence_frame_length=cfg["sentence_frame_length"], fps=cfg["fps"],
        max_words=cfg["max_words"], mode="decode", seed=seed,
        window_carry=True, use_fused_decoder=True,
        temperature=cfg["temperature"],
        stage0_temperature=cfg["stage0_temperature"], device=device)
