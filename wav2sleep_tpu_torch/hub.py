"""Hugging Face Hub integration: the checkpoint variants and their model card.

The port's counterpart of ``wav2sleep_tpu/hub.py``: the same variant
registry, ``hf://`` URIs and model card (naming this implementation). The
port runs where there is no network, so ``download_from_hub`` and
``upload_to_hub`` raise ``HubUnavailable``: download a checkpoint folder
(``config.yaml`` + ``state_dict.pth``) elsewhere and pass its path.
"""

from __future__ import annotations

from typing import Optional

MODEL_VARIANTS = {
    'wav2sleep': {
        'signals': ['ECG', 'PPG', 'ABD', 'THX'],
        'num_classes': 4,
        'causal': False,
        'description': 'Cardio-respiratory sleep staging (4-class: Wake, Light, Deep, REM)',
    },
    'wav2sleep-eog': {
        'signals': ['EOG-L', 'EOG-R'],
        'num_classes': 5,
        'causal': False,
        'description': 'EOG-based sleep staging (5-class: Wake, N1, N2, N3, REM)',
    },
}


def is_hf_repo_id(path_or_repo: str) -> bool:
    """True for ``hf://user/repo`` URIs."""
    return path_or_repo.startswith('hf://')


class HubUnavailable(ValueError):
    """The Hugging Face Hub is not reached from the port."""


def download_from_hub(repo_id: str, revision: Optional[str] = None, cache_dir: Optional[str] = None) -> str:
    """Refuse: the port reads local checkpoint folders only."""
    raise HubUnavailable(
        f'{repo_id}: downloading from the Hugging Face Hub is not ported; '
        'download the checkpoint folder and pass its path'
    )


def upload_to_hub(
    local_folder: str,
    repo_id: str,
    variant_name: Optional[str] = None,
    private: bool = False,
    token: Optional[str] = None,
) -> str:
    """Refuse: the port does not reach the Hugging Face Hub."""
    raise HubUnavailable(f'{repo_id}: uploading to the Hugging Face Hub is not ported; upload {local_folder} elsewhere')


def generate_model_card(variant_name: str) -> str:
    """Markdown model card with HF frontmatter for a known variant."""
    if variant_name not in MODEL_VARIANTS:
        raise ValueError(f"Unknown variant '{variant_name}'. Valid variants: {list(MODEL_VARIANTS.keys())}")
    variant = MODEL_VARIANTS[variant_name]
    signals = variant['signals']
    if 'EOG-L' in signals:
        signal_desc = 'electrooculography (EOG)'
    else:
        signal_desc = 'cardio-respiratory signals (ECG, PPG, respiratory)'
    causal_desc = 'Causal (real-time capable)' if variant['causal'] else 'Non-causal (bidirectional)'

    return f"""---
license: mit
tags:
  - sleep-staging
  - wav2sleep
  - polysomnography
  - time-series
  - pytorch
library_name: wav2sleep-tpu
pipeline_tag: other
---

# {variant_name}

{variant['description']}

## Model Description

A **wav2sleep** model for automatic sleep stage classification from
{signal_desc}: a unified multi-modal network that accepts any subset of its
training modalities at inference time. This checkpoint is served on NVIDIA
GPUs by the PyTorch / CUDA implementation (`wav2sleep_tpu_torch`); the
weights are stored in the original PyTorch `state_dict.pth` format and
remain loadable by the upstream PyTorch implementation and by the JAX
implementation (`wav2sleep_tpu`).

- **Paper**: [wav2sleep: A Unified Multi-Modal Approach to Sleep Stage Classification](https://arxiv.org/abs/2411.04644)
- **Architecture**: {causal_desc}
- **Input Signals**: {', '.join(signals)}
- **Output Classes**: {variant['num_classes']}

### Signal Specifications

| Signal | Samples per 30s epoch |
|--------|----------------------|
| ECG, PPG | 1,024 |
| ABD, THX | 256 |
| EOG-L, EOG-R | 4,096 |

## Usage

```python
from wav2sleep_tpu_torch import load_model, predict_on_folder

# A local copy of hf://joncarter/{variant_name}.
model = load_model("/path/to/{variant_name}")
predict_on_folder(
    input_folder="/path/to/edf_files",
    output_folder="/path/to/predictions",
    model=model,
)
```

## Citation

```bibtex
@misc{{carter2024wav2sleep,
    title={{wav2sleep: A Unified Multi-Modal Approach to Sleep Stage Classification from Physiological Signals}},
    author={{Jonathan F. Carter and Lionel Tarassenko}},
    year={{2024}},
    eprint={{2411.04644}},
    archivePrefix={{arXiv}},
    primaryClass={{cs.LG}},
}}
```

## License

MIT
"""
