"""The benchmark's plain reference: bins, trees and boosted rounds worked
out again from the raw rows with plain PyTorch and NumPy, on whatever
device the tensors live on. It imports nothing of the program under test
and takes nothing that the program made: the comparison that decides a
run's ``correct`` (``compare.py``) reads the program's fitted model only
to judge it."""
