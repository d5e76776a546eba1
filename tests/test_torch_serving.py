"""Port vs reference: the serving Engine, greedy token for token.

Both engines serve the same requests on the same smoke weights with fp32
activations (bf16 rounds differently in the two frameworks and can flip a
near-tied argmax), two slots and more requests than slots, so admission
packs prompts of mixed lengths, slots churn and freed slots are re-filled.
Greedy decoding must agree exactly: tolerance zero, token for token.
Temperature draws come from different generators on the two sides, so
they are held to the distribution instead: the total variation between
1,200 draws and softmax(logits / T) must stay under 0.13, the pattern and
bound of ``tests/test_verify.py::test_temperature_rejection_sampling_
distribution``.  At T = 0.05 the smoke model's next-token distribution
has few effective categories (p_max 0.37), so exact draws sit well under
the bound; at T = 0.1 and above the 99th percentile of exact draws of
1,200 already exceeds it (0.19 at T = 0.1; 0.28 at T = 1.0, the JAX
test's temperature, where the smoke model's 512 categories are near
uniform).  Each test also checks the bound's power on its own
distribution (``check_tv_power``): the 99th percentile of 200 simulated
runs of exact numpy draws lies under it, while a greedy sampler (TV
1 - p_max) and the 1st percentile of draws at the wrong temperature (2T,
T / 2 or 1) lie above it.
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
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.worker import sample_tokens  # noqa: E402

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


TRIALS, TEMP, TV_BOUND = 1200, 0.05, 0.13


def total_variation(tokens, p_exact) -> float:
    counts = np.bincount(np.asarray(tokens), minlength=p_exact.size)
    return 0.5 * float(np.abs(counts / len(tokens) - p_exact).sum())


def tempered(logits, temp):
    return torch.softmax(logits.double() / temp, -1).numpy()


def draws_tv_percentile(p_draw, p_exact, q, runs=200) -> float:
    """The q-th percentile of the TV against ``p_exact`` of TRIALS numpy
    draws from ``p_draw``."""
    rng = np.random.default_rng(0)
    return float(np.percentile([total_variation(rng.choice(
        p_draw.size, TRIALS, p=p_draw / p_draw.sum()), p_exact)
        for _ in range(runs)], q))


def check_tv_power(logits):
    """The bound tells right from wrong on these logits: exact draws pass
    it (99th percentile), a greedy sampler and draws at a wrong
    temperature fail it (1st percentile).  Returns softmax(logits / T)."""
    p_exact = tempered(logits, TEMP)
    assert draws_tv_percentile(p_exact, p_exact, 99) < TV_BOUND
    assert 1.0 - p_exact.max() > TV_BOUND  # the TV of a greedy sampler
    for wrong in (2 * TEMP, TEMP / 2, 1.0):
        assert draws_tv_percentile(tempered(logits, wrong), p_exact,
                                   1) > TV_BOUND, f"T = {wrong}"
    return p_exact


def next_token_logits(params, cfg, prompt):
    with torch.no_grad():
        logits, _ = lm.prefill(params, torch.from_numpy(prompt)[None], cfg,
                               max_len=64, dtype=torch.float32)
    return logits[0, -1]


def test_sample_tokens_draws_from_the_tempered_softmax(weights):
    _, _, cfg, params = weights
    with torch.no_grad():
        logits, _ = lm.prefill(params, torch.from_numpy(
            prompts(cfg.vocab_size)[0])[None], cfg, max_len=64,
            dtype=torch.float32)
    p_exact = check_tv_power(logits[0, -1])
    rows = logits[:, -1].expand(TRIALS, -1)
    temps = torch.full((TRIALS,), TEMP)
    live = torch.ones(TRIALS, dtype=torch.bool)
    drawn = sample_tokens(torch.Generator().manual_seed(0), rows, temps, live)
    tv = total_variation(drawn.numpy(), p_exact)
    assert tv < TV_BOUND, f"sample_tokens TV {tv:.3f}"
    # greedy rows and dead rows are untouched by the generator
    temps[::2] = 0.0
    live[1::4] = False
    mixed = sample_tokens(torch.Generator().manual_seed(1), rows, temps,
                          live).numpy()
    greedy = int(logits[0, -1].argmax())
    assert (mixed[::2] == greedy).all() and (mixed[1::4] == 0).all()


def test_engine_temperature_draws_follow_the_tempered_softmax(weights):
    """Every request retires with its first token, drawn at admission: the
    draws of 1,200 requests on one prompt against softmax(logits / T)."""
    _, _, cfg, params = weights
    prompt = prompts(cfg.vocab_size)[0]
    p_exact = check_tv_power(next_token_logits(params, cfg, prompt))
    engine = Engine(params, cfg, slots=64, max_len=64, seed=3,
                    dtype=torch.float32, device="cpu")
    for uid in range(TRIALS):
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=1,
                              temperature=TEMP))
    done = engine.run()
    assert len(done) == TRIALS and engine.worker.decode_steps == 0
    tv = total_variation([r.generated[0] for r in done], p_exact)
    assert tv < TV_BOUND, f"Engine TV {tv:.3f}"
