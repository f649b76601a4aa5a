"""Host-side data: EDF reading and resampling for the serving pipelines
(numpy only), the per-night parquet files and dataset of training
(``parquet``, the one module that uses pyarrow, and ``dataset``), and the
corpus path's annotation parsers (``xml``, ``txt``), split lists (``nsrr``)
and synthetic nights (``synth``)."""

from .edf import get_edf_end, get_edf_start
from .nsrr import get_dataset, get_split, import_splits
from .txt import parse_txt_annotations
from .utils import convert_int_stage, convert_str_stage
from .xml import parse_xml_annotations

__all__ = [
    'convert_int_stage',
    'convert_str_stage',
    'get_dataset',
    'get_edf_end',
    'get_edf_start',
    'get_split',
    'import_splits',
    'parse_txt_annotations',
    'parse_xml_annotations',
]
