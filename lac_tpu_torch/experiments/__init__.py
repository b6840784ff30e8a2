"""Measured experiments of the port, on no product path
(lac_tpu/ops/device_pack.py, lac_tpu/ops/device_reader.py).

* :mod:`.device_pack`: the token body packed on the card (prefix-sum bit
  offsets and word scatter-adds), byte-identical to
  ``bitio.pack.pack_stream`` and the native packer;
* :mod:`.device_reader`: static-Rice partitions parsed on the card, by
  pointer doubling in torch ops or by kernel 8 (``csrc/rice_scan.cu``,
  one thread per lane, one token a step);
* :mod:`.bench_device_pack`, :mod:`.bench_device_reader`: their bench scripts,
  on the card by default (``--device cpu`` for the CPU), against the
  native runtime's packer and tokenizer.
"""
