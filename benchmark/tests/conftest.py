"""Shared tiny sizes for the benchmark's CPU tests, and the ``card``
marker: a test that needs a CUDA card takes the ``card`` fixture, which
skips it when there is none (decided when the test runs, never at
import). Run them all from the repo root: ``python -m pytest
benchmark/tests -q``."""
import pytest
import torch

TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=128, num_hidden_layers=2, vocab_size=256,
            torch_dtype="float32")
TINY_CELL = {"engine": {"slots": 4, "max_seq": 256,
                        "prompt_buckets": [32, 64]},
             "rate_per_s": 8.0, "preload": 2,
             "limits": {"max_logit_gap": 1e-3, "min_tokens_judged": 20}}
TINY_MIX = {"prompt": {"dist": "lognormal", "median": 24, "sigma": 0.5,
                       "min": 4, "max": 64},
            "output": {"dist": "lognormal", "median": 12, "sigma": 0.5,
                       "min": 2, "max": 40},
            "warm_s": 0.3, "close_wait_s": 60, "requests": 400}


TINY_TRAIN_CELL = {"limits": {"grad_norm_gap": 1e-2,
                              "change_norm_gap": 1e-2}}
TINY_TRAIN_MIX = {"seq": 32, "batch": 2}


def tiny_overrides(cell: str) -> dict:
    """The cell and mix overrides of a tiny CPU run of ``cell``."""
    if cell.endswith("train-4k"):
        return {"cell_override": TINY_TRAIN_CELL,
                "mix_override": TINY_TRAIN_MIX}
    return {"cell_override": TINY_CELL, "mix_override": TINY_MIX}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny_conf(moe: bool = False) -> dict:
    """A configuration file's keys at the tiny sizes (dense, or with 4
    experts, top-2)."""
    from benchmark import model
    conf = model.load_config("mixtral-8x7b" if moe else "mistral-7b")
    return dict(conf, **TINY, **({"num_local_experts": 4} if moe else {}))
