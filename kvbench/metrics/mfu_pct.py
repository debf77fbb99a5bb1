"""The whole decode step's share of the card's fp32 peak, in %: the model
FLOPs of the window's decoded tokens (two a weight each token multiplies
through, its top-k experts and the LM head included, plus the attention
over the tokens each layer attended, counted from kernel B's launches)
over the window's seconds times 67 TFLOP/s."""


def read(rec):
    t = rec["trace"]
    k = (t or {}).get("kernels", {}).get("gather_attention", {})
    if not (rec["on_card"] and k.get("launches") and rec["window_s"] > 0):
        return None
    flops = rec["flops_per_token"] * rec["decoded_rows"] + k["attention_flops"]
    return 100.0 * flops / (rec["window_s"] * rec["peak_flops"])
