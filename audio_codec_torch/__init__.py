"""audio_codec_torch: the LC3plus (ETSI TS 103 634) codec on PyTorch and CUDA.

A port of `audio_codec_tpu`, the JAX package beside it, which stays the
reference. Streams ride a [n_streams, ...] batch axis as there. The
per-stream loops and transforms of the main path, the channel coder of the
stream engine (StreamEncoder/StreamDecoder) and the stages of the bit-exact
fixed-point decoder (DeviceFixedDecoder) are CUDA kernels written for
Hopper (csrc/); each has a plain PyTorch version that runs for tensors
on the CPU. The entry points run on the card unless the caller passes
device="cpu".
"""
from .config import Config
from .engine import StreamDecoder, StreamEncoder
from .fixed_decoder_dev import DeviceFixedDecoder
from .models.decoder import decode_block, decode_frame, round_pcm
from .models.encoder import encode_block, encode_frame
from .models.state import dec_state_init, enc_state_init

__all__ = ["Config", "enc_state_init", "dec_state_init", "encode_frame",
           "encode_block", "decode_frame", "decode_block", "round_pcm", "StreamEncoder",
           "StreamDecoder", "DeviceFixedDecoder"]
