"""Importable CLI entry point: delegates to the predict CLI."""

from .predict import main

if __name__ == '__main__':
    main()
