"""CPU tests of the benchmark (``python -m pytest benchmark/tests`` from the
checkout's root); the tests marked ``cuda`` run only on the card."""
