"""Host-side data: EDF reading and resampling for the serving pipelines
(numpy only), and the per-night parquet files and dataset of training
(``parquet``, the one module that uses pyarrow, and ``dataset``)."""
