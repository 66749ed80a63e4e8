"""Random backoff n-gram prob_dicts for the port's LM tests, with no JAX
(the card tests import it too)."""

import numpy as np


def random_prob_dicts(V, N, seed, sos, density=0.5):
    """Random well-formed backoff prob_dicts (tests/test_lm.py's recipe):
    ids in [0, V), sos allowed in contexts."""
    rng = np.random.RandomState(seed)
    dicts = []
    vocab = list(range(V))
    ctx_vocab = vocab + [sos]
    for n in range(1, N + 1):
        d = {}
        if n == 1:
            for w in vocab:
                logp = float(-rng.rand() * 3 - 0.1)
                d[w] = logp if N == 1 else (logp, float(-rng.rand()))
            if N > 1:
                d[sos] = (float("-inf"), float(-rng.rand()))
        else:
            count = max(1, int(density * V ** min(n, 2) * 2))
            for _ in range(count):
                key = tuple(int(rng.choice(ctx_vocab)) for _ in range(n - 1)) + (
                    int(rng.choice(vocab)),
                )
                val = float(-rng.rand() * 5 - 0.1)
                d[key] = val if n == N else (val, float(-rng.rand()))
        dicts.append(d)
    return dicts


def fused_prob_dicts(V, N, seed, density=60):
    """tests/test_decoding.py's ``_random_fused_lm`` draws: ``density``
    random n-grams per order above 1, sos = V allowed in contexts."""
    rng = np.random.RandomState(seed)
    sos = V
    uni = {w: (float(-rng.rand() * 5 - 0.1), float(-rng.rand())) for w in range(V)}
    uni[sos] = (float("-inf"), float(-rng.rand()))
    dicts = [uni]
    ctx_pool = list(range(V)) + [sos]
    for n in range(2, N + 1):
        d = {}
        for _ in range(density):
            key = tuple(int(rng.choice(ctx_pool)) for _ in range(n - 1)) + (
                int(rng.randint(V)),
            )
            val = float(-rng.rand() * 5 - 0.1)
            d[key] = val if n == N else (val, float(-rng.rand()))
        dicts.append(d)
    return dicts
