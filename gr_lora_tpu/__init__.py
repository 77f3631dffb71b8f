"""gr_lora_tpu — a LoRa PHY framework in JAX for a GPU.

A from-scratch JAX/XLA re-design of the capabilities of the
jkadbear/gr-lora GNU Radio module: chirp modulation, single-packet
demodulation, the Pyramid real-time collision decoder, a weak-signal
demodulator, and the full bit-level codec (whitening, Hamming FEC, diagonal
interleaving, Gray mapping, CRC16) — batched over channels and spreading
factors and sharded over device meshes.
"""

from .config import LoraConfig, PeakSearch

__version__ = "0.2.0"
__all__ = ["LoraConfig", "PeakSearch", "blocks", "blocks_meta", "__version__"]

_LAZY = ("blocks", "blocks_meta", "native")


def __getattr__(name):
    # Lazy: the block-style API pulls in model modules on first touch.
    # (importlib, not `from . import`, to avoid __getattr__ recursion.)
    if name in _LAZY:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
