"""The port's text stack (tokenizer, tower, encoder, vocabulary builder)
against the JAX package on the CPU.

Weights: a miniature tower (width 64, 2 layers, 77 positions, the full
49408-token table, 512-d output) from JAX random params perturbed with
numpy noise, carried over with `text_state_dict_from_flax`. Inputs: the
same prompts, ASCII and not.

Tolerances: token ids exact; embeddings atol 1e-5 (fp32, the two
frameworks sum in different orders).
"""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yoloclip_tpu.text.encoder import CLIPTextEncoder as JaxEncoder
from yoloclip_tpu.text.encoder import save_text_tower_params
from yoloclip_tpu.text.model import CLIPTextTransformer as JaxTower
from yoloclip_tpu.text.model import convert_openai_state_dict
from yoloclip_tpu.text.tokenizer import CLIPTokenizer as JaxTokenizer
from yoloclip_tpu.text.vocab import VocabularyBuilder as JaxVocab
from yoloclip_tpu_torch.text import tokenizer as port_tok
from yoloclip_tpu_torch.text.encoder import CLIPTextEncoder, _bucket
from yoloclip_tpu_torch.text.model import (CLIPTextTransformer,
                                           init_text_weights)
from yoloclip_tpu_torch.text.vocab import VocabularyBuilder
from yoloclip_tpu_torch.utils.convert import text_state_dict_from_flax

torch.set_num_threads(2)

ATOL = 1e-5
PROMPTS = ['a photo of a cat', 'dog', 'café au lait', '日本の猫',
           'naïve résumé', 'e&#769;tude', "it's a DOG's   life!",
           'traffic light 42', 'Ünïcödé zebra']
MERGE_WORDS = ['cat', 'dog', 'photo', 'zebra', 'life']


def write_merges_gz(path):
    """A truncated merges file in the real bpe_simple_vocab_16e6.txt.gz
    layout (a header line, then pairs in rank order) that composes each of
    MERGE_WORDS into one token, left to right."""
    merges = []
    for w in MERGE_WORDS:
        acc = w[0]
        for ch in w[1:-1]:
            if (acc, ch) not in merges:
                merges.append((acc, ch))
            acc += ch
        if (acc, w[-1] + '</w>') not in merges:
            merges.append((acc, w[-1] + '</w>'))
    with gzip.open(path, 'wt', encoding='utf-8') as f:
        f.write('#version: 0.2\n')
        for a, b in merges:
            f.write(f'{a} {b}\n')


@pytest.fixture(scope='module')
def mini_params():
    """Miniature JAX tower params as a numpy tree, every leaf perturbed so
    that biases and LayerNorm scales are not their init constants."""
    params = JaxTower(width=64, layers=2, heads=1, output_dim=512).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))['params']
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.02 * rng.randn(*np.shape(p))
                   ).astype(np.float32), params)


@pytest.fixture(scope='module')
def encoders(mini_params):
    tok_j, tok_p = JaxTokenizer(merges=[]), port_tok.CLIPTokenizer(merges=[])
    jenc = JaxEncoder(params=mini_params, tokenizer=tok_j)
    penc = CLIPTextEncoder(state_dict=text_state_dict_from_flax(mini_params),
                           tokenizer=tok_p, device='cpu')
    return jenc, penc


def test_token_ids_match_zero_merge_and_bpe(tmp_path):
    gz = str(tmp_path / 'merges.txt.gz')
    write_merges_gz(gz)
    for kw in ({'merges': []}, {'bpe_path': gz}):
        want, got = JaxTokenizer(**kw), port_tok.CLIPTokenizer(**kw)
        assert got.degraded == want.degraded == ('merges' in kw)
        np.testing.assert_array_equal(got.tokenize(PROMPTS),
                                      want.tokenize(PROMPTS))
        assert got.decode(got.encode('café')) == want.decode(
            want.encode('café'))
    assert port_tok.word_split("it's 日本 x2!") == ["it", "'s", '日本', 'x',
                                                    '2', '!']
    merged = port_tok.CLIPTokenizer(bpe_path=gz).encode('a cat')
    assert merged[-1] >= 512                  # 'cat</w>' is one merge id
    long = port_tok.CLIPTokenizer(merges=[]).tokenize(['x ' * 100])
    assert long.shape == (1, 77) and long[0, -1] == port_tok.VOCAB_SIZE - 1


def test_find_bpe_file_follows_env(tmp_path, monkeypatch):
    gz = str(tmp_path / 'merges.txt.gz')
    write_merges_gz(gz)
    monkeypatch.setenv('CLIP_BPE_PATH', gz)
    assert port_tok.find_bpe_file() == gz
    assert not port_tok.CLIPTokenizer().degraded


def test_tower_matches_jax(mini_params):
    """Two heads at width 64, so the head split is exercised too."""
    tok = JaxTokenizer(merges=[]).tokenize(PROMPTS)
    want = JaxTower(width=64, layers=2, heads=2, output_dim=512).apply(
        {'params': mini_params}, jnp.asarray(tok))
    tower = CLIPTextTransformer(width=64, layers=2, heads=2, output_dim=512)
    tower.load_state_dict(text_state_dict_from_flax(mini_params), strict=True)
    with torch.no_grad():
        got = tower(torch.from_numpy(tok).long())
    assert got.dtype == torch.float32 and got.shape == (len(PROMPTS), 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_text_state_dict_inverts_openai_conversion(mini_params):
    sd = text_state_dict_from_flax(mini_params)
    back = convert_openai_state_dict({k: v.numpy() for k, v in sd.items()})
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(mini_params))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])


def test_encoder_matches_jax_with_cache_bucket_and_nesting(encoders):
    jenc, penc = encoders
    flat = PROMPTS[:5]                             # 5 -> bucket of 8
    assert _bucket(5) == 8 and _bucket(8) == 8 and _bucket(1) == 1
    got = penc(flat)
    np.testing.assert_allclose(got.numpy(), np.asarray(jenc(flat)), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    assert set(penc._cache) == set(flat)
    cached = penc._cache[flat[0]]
    again = penc(flat[:2] + PROMPTS[5:7])          # 2 cached, 2 new
    assert penc._cache[flat[0]] is cached          # not re-encoded
    np.testing.assert_allclose(again.numpy(),
                               np.asarray(jenc(flat[:2] + PROMPTS[5:7])),
                               rtol=0, atol=ATOL)
    nested = [PROMPTS[:3], PROMPTS[3:4], PROMPTS[4:8]]
    gn, wn = penc(nested), np.asarray(jenc(nested))
    np.testing.assert_allclose(gn.numpy(), wn, rtol=0, atol=ATOL)
    # the mean over a sample's prompts is not renormalised
    assert gn[0].norm() < 0.999
    np.testing.assert_allclose(penc.encode_vocabulary(['cat']).numpy(),
                               np.asarray(jenc.encode_vocabulary(['cat'])),
                               rtol=0, atol=ATOL)
    assert penc([]).shape == (0, 512)


def test_vocabulary_builder_and_json_round_trip(encoders, tmp_path):
    jenc, penc = encoders
    names = ['cat', 'traffic light', 'café']
    jv, pv = JaxVocab(jenc), VocabularyBuilder(penc)
    got = pv.build_online_vocabulary(names)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jv.build_online_vocabulary(names)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    path = str(tmp_path / 'sub' / 'vocab.json')
    saved = pv.build_offline_vocabulary(names, path)
    assert list(saved) == names
    loaded = VocabularyBuilder(penc).load_offline_vocabulary(path)
    assert list(loaded) == names
    want = JaxVocab(jenc).load_offline_vocabulary(path)
    for n in names:
        np.testing.assert_array_equal(loaded[n], want[n])
        np.testing.assert_allclose(loaded[n], got[names.index(n)].numpy(),
                                   rtol=0, atol=1e-7)
    # a matrix over known and new classes encodes only the new one
    mat = pv.get_vocabulary_matrix(['café', 'dog', 'cat'])
    np.testing.assert_allclose(
        mat.numpy(),
        np.asarray(jv.get_vocabulary_matrix(['café', 'dog', 'cat'])),
        rtol=0, atol=ATOL)
    assert set(pv.offline_vocab) == set(names) | {'dog'}


def test_checkpoint_files_load(mini_params, encoders, tmp_path):
    _, penc = encoders
    npz = str(tmp_path / 'tower.npz')
    save_text_tower_params(mini_params, npz)
    from_npz = CLIPTextEncoder(checkpoint_path=npz, device='cpu',
                               tokenizer=penc.tokenizer)
    assert from_npz.model.width == 64 and from_npz.model.layers == 2
    assert from_npz.model.heads == 1 and not from_npz.random_init
    pth = str(tmp_path / 'clip.pth')
    sd = {k: v.half() for k, v in penc.model.state_dict().items()}
    sd['visual.proj'] = torch.zeros(8, 512)        # full-model dumps
    sd['logit_scale'] = torch.tensor(4.6)
    torch.save(sd, pth)
    from_pth = CLIPTextEncoder(checkpoint_path=pth, device='cpu',
                               tokenizer=penc.tokenizer)
    want = penc(PROMPTS[:4])
    np.testing.assert_allclose(from_npz(PROMPTS[:4]).numpy(), want.numpy(),
                               rtol=0, atol=1e-6)
    # the .pth was stored in fp16: its weights round, the shapes agree
    assert from_pth(PROMPTS[:4]).shape == want.shape
    with pytest.raises(NotImplementedError,
                       match='tools/orbax_to_torch.py --text'):
        CLIPTextEncoder(checkpoint_path=str(tmp_path), device='cpu')
    with pytest.raises(ValueError, match='embed_dim'):
        CLIPTextEncoder(checkpoint_path=npz, embed_dim=256, device='cpu')


def test_quality_issues_and_seeded_random_init():
    tok = port_tok.CLIPTokenizer(merges=[])
    enc = CLIPTextEncoder(seed=1, tokenizer=tok, device='cpu')
    issues = enc.quality_issues()
    assert len(issues) == 2 and 'RANDOM-INIT' in issues[0]
    assert 'zero-merge' in issues[1]
    m = enc.model                     # ViT-B/32 at full width
    assert (m.layers, m.width, m.heads, m.context_length, m.vocab_size,
            m.output_dim) == (12, 512, 8, 77, 49408, 512)
    w = m.token_embedding.weight
    assert not w.requires_grad and abs(float(w.std()) - 0.02) < 1e-3
    # the same init on a miniature tower: equal seeds, equal weights
    towers = [CLIPTextTransformer(width=64, layers=1) for _ in range(3)]
    for t, seed in zip(towers, (1, 1, 2)):
        init_text_weights(t, torch.Generator().manual_seed(seed))
    sa, sb, sc = (t.state_dict() for t in towers)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa['token_embedding.weight'],
                           sc['token_embedding.weight'])
