"""Constants of the integer-exact LTPF decoder post-filter
(`audio_codec_tpu/ops/fixed_ltpf.py:98-121`; ltpf_decoder_fx.c,
setup_dec_lc3.c): the crossfade steps, the history lengths and the
post-filter's scale-factor index. The filter itself is `fixed_ltpf_dev.py`."""
from __future__ import annotations

# the crossfade's alpha step per overlap length (ltpf_decoder_fx.c)
_FADE_STEP = {20: 1638, 40: 819, 60: 546, 80: 409, 120: 273}


def mem_lens(fs: int) -> tuple[int, int]:
    """ltpf_mem_x_len / ltpf_mem_y_len (setup_dec_lc3.c:105-107)."""
    f = max(16000, fs)
    x_len = ((f * 16778) >> 15 >> 11) - 2
    y_len = ((((fs * 18678) >> 15) - 1) >> 5) + 1 + ((f * 16778) >> 15 >> 12)
    return x_len, y_len


def scale_fac_idx_for(total_bits: int, fs_idx: int, frame_dms: int = 100) -> int:
    """ltpf_scale_fac_idx derivation (setup_dec_lc3.c:280-332); -1 turns
    the post-filter off."""
    tmp = 80 * fs_idx
    tb = total_bits
    if frame_dms == 25:
        tb = (19661 * total_bits) >> 13
    elif frame_dms == 50:
        tb = total_bits * 2 - 160
    for idx, thr in enumerate((320, 400, 480, 560)):
        if tb < thr + tmp:
            return idx
    return -1
