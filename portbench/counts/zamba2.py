"""Parameters, model FLOPs of a train step, and the SSD forward's
operations and bytes of the zamba2 hybrid, from its numbers (a
configuration's `model`) and the step's shapes. Imports nothing of the
program.

Model FLOPs count each product the model needs once: 2 a multiply-add
in the forward, twice that in the backward, and none of remat's
recomputation."""
from __future__ import annotations


def _dims(m: dict) -> dict:
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    di = m["ssm_expand"] * m["d_model"]
    pad = m.get("vocab_pad_to", 128)
    return {"hd": hd, "di": di, "H": di // m["ssm_headdim"],
            "V": -(-m["vocab_size"] // pad) * pad,
            "U": m["n_layers"] // m["shared_attn_interval"]}


def mamba2_layer_params(m: dict) -> int:
    """One Mamba2 layer with its pre-norm: the five projections, the
    three convs (taps and bias), A_log, D, dt_bias, the gate's norm and
    the output projection."""
    d, n, k = m["d_model"], m["ssm_state"], m["ssm_conv"]
    x = _dims(m)
    di, H = x["di"], x["H"]
    return (d + d * (2 * di + 2 * n + H) + (k + 1) * (di + 2 * n) + 3 * H
            + di + di * d)


def shared_block_params(m: dict) -> int:
    """The shared attention and SwiGLU block with its two norms."""
    d, f = m["d_model"], m["d_ff"]
    hd = _dims(m)["hd"]
    return (2 * d + d * hd * (2 * m["n_heads"] + 2 * m["n_kv_heads"])
            + 3 * d * f)


def params(m: dict) -> int:
    """Every parameter: embedding and head tables (the vocab padded to
    `vocab_pad_to`), the layers, the shared block once, the final norm."""
    d = m["d_model"]
    return (2 * _dims(m)["V"] * d + m["n_layers"] * mamba2_layer_params(m)
            + shared_block_params(m) + d)


def attention_flops(m: dict, batch: int, seq: int) -> int:
    """One causal attention forward: Q.K^T and P.V over the pairs on and
    below the diagonal."""
    pairs = seq * (seq + 1) // 2
    return 2 * 2 * batch * m["n_heads"] * _dims(m)["hd"] * pairs


def ssd_forward(m: dict, batch: int, seq: int, chunk: int) -> dict:
    """One chunked SSD scan forward (`seq` a multiple of `chunk`): C.B^T
    on and below each chunk's diagonal once a batch row; a head's masked
    product with x, its read of the carried state through C and the
    state's update. Bytes: x, dt, A, B, C, D read once; y and the final
    state written once."""
    n, p = m["ssm_state"], m["ssm_headdim"]
    H = _dims(m)["H"]
    chunks = seq // chunk
    tri = chunk * (chunk + 1) // 2
    flops = 2 * batch * chunks * (tri * n + H * (tri * p + 2 * chunk * n * p))
    x = batch * seq * H * p
    nbytes = (2 * x + 4 * batch * seq * H + 4 * 2 * H + 2 * 2 * batch * seq * n
              + 2 * x + 4 * batch * H * p * n)
    return {"flops": flops, "bytes": nbytes}


def train_step_flops(m: dict, batch: int, seq: int, chunk: int) -> int:
    """Model FLOPs of one train step of `batch` x `seq` tokens: 6 a
    parameter and a token for every parameter outside the embedding
    table, the shared block counted at each of its invocations; plus
    three times attention's and the SSD scan's forward products."""
    x = _dims(m)
    tokens = batch * seq
    used = (params(m) - x["V"] * m["d_model"]
            + (x["U"] - 1) * shared_block_params(m))
    return (6 * used * tokens
            + 3 * x["U"] * attention_flops(m, batch, seq)
            + 3 * m["n_layers"] * ssd_forward(m, batch, seq, chunk)["flops"])
