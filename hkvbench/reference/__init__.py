"""The benchmark's plain reference: the table's and the embedding's
semantics in plain PyTorch, which decide whether a run is `correct`.  It
imports nothing of the program under test."""
