"""Test-sized overrides of the cells: the same estimators and the same
check, on 20,000 rows of the same generator."""

ROWS = 20_000
# boosting on the CPU runs its host loop unless asked for the fused
# rounds, which are what the card runs at rounds_per_dispatch="auto"
SMALL = {
    "covtype_tree.fit": {"data": {"rows": ROWS}, "params": {"max_depth": 8}},
    "covtype_tree.fit_balanced": {"data": {"rows": ROWS},
                                  "params": {"max_depth": 8}},
    "covtype_gbdt.fit": {"data": {"rows": ROWS},
                         "params": {"max_iter": 4, "rounds_per_dispatch": 8}},
}
SEED = 2**31 + 5
