"""The corpus-building command lines, in the order they run:

1. ``python -m wav2sleep_tpu_torch.preprocessing.fix_edfs`` repairs EDFs
   whose channels have a physical maximum of 0.0 (CHAT);
2. ``python -m wav2sleep_tpu_torch.preprocessing.ingest`` turns a dataset's
   EDF and annotation nights into ``<output>/<dataset>/ingest/*.parquet``;
3. ``python -m wav2sleep_tpu_torch.preprocessing.create_splits`` links them
   into ``train``, ``val`` and ``test`` by the split lists;
4. ``python -m wav2sleep_tpu_torch.preprocessing.census_split`` assembles
   the census-balanced val and test sets across datasets.
"""
