"""Quality parity — own copy of the JAX package's ``quality/``: an
independent, MLlib-semantics-faithful CPU reference ALS held against the
port's ALS (`ops/als.py`) on identical data.

- `datasets`  — deterministic planted-factor MovieLens-like generators
                with held-out splits (the ML-100K/2M/20M shapes).
- `mllib_als` — a from-scratch numpy implementation of MLlib's ALS math
                (ALS-WR weighted-λ, Hu-Koren-Volinsky implicit, MLlib's
                unit-norm gaussian init), sharing NO code with ops/als.py.
- `parity`    — trains both on identical triplets (the port's on the
                card unless asked for the CPU) and reports held-out RMSE /
                MAP@10 side by side.

`python -m predictionio_torch.quality --help` for the command line.
"""

from predictionio_torch.quality.mllib_als import mllib_als_train  # noqa: F401
