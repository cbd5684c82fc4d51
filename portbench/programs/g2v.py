"""The system under test, built from a configuration and loaded with
the benchmark's weights: the port's entry points, and nothing of the
port beyond them. The weights are named as the port's modules name their
tensors (`strict` loading: a renamed tensor fails loudly)."""
from portbench.harness import weights as wts

# the vocabulary's special ids (PAD, SOS, EOS, UNK) come first
N_SPECIAL = 4


def generator(cfg: dict, weights: dict, seed: int, device):
    """The program under test, loaded with the benchmark's weights: the
    port's GestureGenerator in decode mode, greedy, window_carry, the
    chunk-decoder kernel, with the TCN text encoder and the attention GRU
    decoder."""
    import torch

    from gesture2vec_tpu_torch.infer.text2gesture import GestureGenerator
    from gesture2vec_tpu_torch.models.dae import DAE
    from gesture2vec_tpu_torch.models.seq_ae import SeqDecoder
    from gesture2vec_tpu_torch.models.text2token import Text2Token
    from gesture2vec_tpu_torch.text.vocab import Vocab

    H, L, K = cfg["hidden_size"], cfg["n_layers"], cfg["codes"]
    n_steps = cfg["sentence_frame_length"] // cfg["n_poses"]
    with torch.device(device):
        t2t = Text2Token(
            n_words=cfg["n_words"], n_tokens=K, hidden_size=H,
            n_layers=L, n_steps=n_steps,
            n_pre_poses=cfg["t2t_n_pre_poses"],
            word_embed_size=cfg["wordembed_dim"],
            encoder_type=cfg["text_encoder"], use_attention=True,
            token_stages=cfg["token_stages"],
            stage_conditional=cfg["stage_conditional"],
            dropout_rate=cfg["dropout_prob"])
        seq = SeqDecoder(cfg["dae_latent"], H, L, cfg["n_poses"], K,
                         n_pre_poses=1, conditioned=True,
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
        window_carry=True, use_fused_decoder=True, device=device)


def train_step(cfg: dict, weights: dict, device):
    """The program under test: the port's tokenizer in training mode,
    its clipped Adam and its Part-b step, loaded with the benchmark's
    weights."""
    import torch

    from gesture2vec_tpu_torch.models.seq_ae import SeqVQAutoencoder
    from gesture2vec_tpu_torch.train.config import load_config
    from gesture2vec_tpu_torch.train.optim import Adam
    from gesture2vec_tpu_torch.train.seq_ae_trainer import TrainStep

    with torch.device(device):
        model = SeqVQAutoencoder(
            rep_dim=cfg["dae_latent"], hidden_size=cfg["hidden_size"],
            n_layers=cfg["n_layers"], n_frames=cfg["n_poses"],
            vq_components=cfg["codes"], n_pre_poses=1,
            vq_variant=cfg["vq_variant"],
            commitment_cost=cfg["vq_commitment_cost"],
            conditioned=cfg["conditioned"], vq_flatten="per_sample",
            encoder_arch="bigru", use_vae=False,
            dropout_rate=cfg["dropout_prob"], use_vq=True)
    state = dict(weights)
    state["decoder.codebook"] = weights["vq_layer.codebook"]
    model.load_state_dict(state, strict=True)
    model.train()
    opt = Adam(model.parameters(), cfg["learning_rate"])
    config = load_config({k: cfg[k] for k in (
        "batch_size", "learning_rate", "loss_l1_weight", "loss_cont_weight",
        "loss_var_weight", "dropout_prob", "hidden_size", "n_layers")})
    return model, opt, TrainStep(config, model, opt)
