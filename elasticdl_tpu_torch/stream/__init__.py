"""Continual streaming training.

(Copy of elasticdl_tpu/stream/__init__.py for the PyTorch port.)

Three pieces, spanning the data layer, master, and PS:

- ``source``    — unbounded/bounded stream sources minting record
  windows: replay of an existing reader's shards, and a synthetic
  clickstream generator with Zipfian drift + vocab churn.
- ``feeder``    — master-side thread turning arriving windows into
  dispatcher tasks (watermark mode) and minting export tasks on
  watermark cadence so the serving tier picks up fresh versions
  continuously.
- ``lifecycle`` — PS-side embedding lifecycle manager: frequency-based
  admission behind a counting sketch, TTL + LFU eviction sweeps with
  journaled tombstones, bounded-memory contract for unbounded vocab.
"""
