"""Shared LM-family shape set (seq_len x global_batch per assignment)."""


def lm_shapes(sub_quadratic: bool) -> dict:
    shapes = {
        "train_4k": {"kind": "train", "seq": 4096, "global_batch": 256},
        "prefill_32k": {"kind": "prefill", "seq": 32768, "global_batch": 32},
        "decode_32k": {"kind": "decode", "seq": 32768, "global_batch": 128},
        "long_500k": {"kind": "decode", "seq": 524288, "global_batch": 1},
    }
    if not sub_quadratic:
        shapes["long_500k"]["skip"] = (
            "pure full-attention arch: 524k decode requires sub-quadratic "
            "attention (assignment rule; see DESIGN.md §4)")
    return shapes
