"""PyTorch/CUDA port of the JPEG decode system.

A second package beside ``repro`` (the JAX reference, which it never
imports). Host stages — parse, Huffman entropy decode, plane assembly —
are copies of the reference's numpy code; the transform stages run on
an NVIDIA card through hand-written CUDA kernels
(``repro_torch.kernels``) or plain PyTorch (the ``torch-*`` paths).

Entry point: ``repro_torch.codecs.open_decoder(name, context=...)``.
Everything runs on ``repro_torch.device.current_device()``, which is
the card unless the caller asked for the CPU.
"""
