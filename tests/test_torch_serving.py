"""Port vs reference: the serving Engine, greedy token for token.

Both engines serve the same requests on the same smoke weights with fp32
activations (bf16 rounds differently in the two frameworks and can flip a
near-tied argmax), two slots and more requests than slots, so admission
packs prompts of mixed lengths, slots churn and freed slots are re-filled.
Greedy decoding must agree exactly: tolerance zero, token for token.
Temperature draws come from different generators on the two sides, so
they are checked for validity only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

PROMPT_LENS = (5, 17, 9, 30, 3, 12)
BUDGETS = (4, 7, 1, 5, 6, 3)  # budget 1 retires at admission


@pytest.fixture(scope="module")
def weights():
    jcfg = j_smoke_config("flowformer_lm")
    jparams = jlm.init(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config("flowformer_lm")
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg)


def prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def serve(engine, request_cls, vocab, temps=None):
    temps = temps or [0.0] * len(PROMPT_LENS)
    for uid, (p, b, tmp) in enumerate(zip(prompts(vocab), BUDGETS, temps)):
        engine.submit(request_cls(uid=uid, prompt=p, max_new_tokens=b,
                                  temperature=tmp))
    return engine.run()


def test_greedy_generations_match_reference_engine(weights):
    jcfg, jparams, cfg, params = weights
    j_done = serve(JEngine(jparams, jcfg, slots=2, max_len=64,
                           dtype=jnp.float32), JRequest, cfg.vocab_size)
    engine = Engine(params, cfg, slots=2, max_len=64, dtype=torch.float32,
                    device="cpu")
    done = serve(engine, Request, cfg.vocab_size)
    assert [r.uid for r in done] == [r.uid for r in j_done]
    for r, jr in zip(done, j_done):
        assert r.done and len(r.generated) == BUDGETS[r.uid]
        assert r.generated == jr.generated, f"request {r.uid}"
    # more requests than slots: several packed admission rounds
    assert engine.worker.admission_rounds >= 3
    assert all(slot is None for slot in engine.active)


def test_temperature_slots_leave_greedy_slots_alone(weights):
    _, _, cfg, params = weights
    greedy = serve(Engine(params, cfg, slots=2, max_len=64,
                          dtype=torch.float32, device="cpu"),
                   Request, cfg.vocab_size)
    temps = [0.0, 1.0, 0.0, 0.7, 1.3, 0.0]
    mixed = serve(Engine(params, cfg, slots=2, max_len=64, seed=3,
                         dtype=torch.float32, device="cpu"),
                  Request, cfg.vocab_size, temps)
    by_uid = {r.uid: r for r in greedy}
    for r in mixed:
        assert len(r.generated) == BUDGETS[r.uid]
        assert all(0 <= tok < cfg.vocab_size for tok in r.generated)
        if temps[r.uid] == 0.0:
            assert r.generated == by_uid[r.uid].generated, f"request {r.uid}"
