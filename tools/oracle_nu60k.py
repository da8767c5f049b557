"""One-time LibSVM nu-SVC oracle at the full MNIST-shaped scale.

The nu-SVC counterpart of tools/oracle60k.py: `sklearn.svm.NuSVC`
(LibSVM's nu dual) once, on the benchmark dataset (make_mnist_like
n=60000, d=784, seed=7, noise=0.1) at nu=0.1, gamma=0.125, tol=1e-3,
and saves what chip_smoke.py's [nu] phase holds the port's nu-SVC
against (the port runs at eps = tol/2, as tools/parity60k.py does):

    artifacts/oracle_nu60k.npz   alpha (n,) = |dual_coef|, dec (n,), y (n,)
    artifacts/oracle_nu60k.json  {n_sv, merged_sv, seconds, acc, params}

Pure CPU (scikit-learn); the card reads only the artifact.
Run: `python tools/oracle_nu60k.py` (minutes; nohup it).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools.parity_common import merged_sv as merged_sv_count

N, D, SEED, NOISE = 60_000, 784, 7, 0.1
NU, GAMMA, EPS = 0.1, 0.125, 0.001


def main() -> int:
    from sklearn.svm import NuSVC

    from dpsvm_tpu.data.synth import make_mnist_like

    outdir = os.path.join(REPO, "artifacts")
    os.makedirs(outdir, exist_ok=True)
    x, y = make_mnist_like(n=N, d=D, seed=SEED, noise=NOISE)
    print(f"[oracle_nu60k] fitting NuSVC(nu={NU}, gamma={GAMMA}, "
          f"tol={EPS}) on {N}x{D} ...", flush=True)
    t0 = time.perf_counter()
    sk = NuSVC(nu=NU, gamma=GAMMA, tol=EPS, cache_size=2000).fit(x, y)
    seconds = time.perf_counter() - t0
    alpha = np.zeros(N)
    alpha[sk.support_] = np.abs(sk.dual_coef_[0])
    dec = sk.decision_function(x)
    acc = float(sk.score(x, y))
    n_sv = int(sk.n_support_.sum())
    msv = merged_sv_count(x, y, alpha)
    np.savez(os.path.join(outdir, "oracle_nu60k.npz"),
             alpha=alpha, dec=dec, y=y)
    summary = dict(n=N, d=D, seed=SEED, noise=NOISE, nu=NU, gamma=GAMMA,
                   eps=EPS, n_sv=n_sv, merged_sv=msv, acc=acc,
                   intercept=float(sk.intercept_[0]),
                   seconds=round(seconds, 1))
    with open(os.path.join(outdir, "oracle_nu60k.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(f"[oracle_nu60k] done: {json.dumps(summary)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
