"""``train.stage_ms`` of the training cells whose rows cross to the card as
q8 codes (the host encode into the ring): the same reader, under the
end-to-end metric of those cells."""

from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name('train.stage_ms.py')).read
