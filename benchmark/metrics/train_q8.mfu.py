"""``train.mfu`` of the training cells whose rows cross to the card as q8
codes: the same reader, under the end-to-end metric of those cells."""

from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name('train.mfu.py')).read
