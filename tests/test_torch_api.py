"""The port's API against the JAX package's, read from both packages'
source with ``ast`` (nothing is imported, so it costs no JAX compile).

For every ``hero_tpu/<mod>.py`` the port has ``hero_tpu_torch/<mod>.py``
with each public top-level function and class, every parameter name of
each, every public method (and ``__init__``) of each class with its
parameter names, and every command-line flag.  What the port lacks on
purpose is in :data:`ALLOWED`, each entry with its reason; an entry that
no longer names a gap fails too, so the list stays the list of
differences.  A JAX package change that the port lacks then fails here
by name.
"""

import ast
import pathlib
from typing import Dict, List, Set, Tuple

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX = REPO / "hero_tpu"
PORT = REPO / "hero_tpu_torch"

# JAX parameter names the port spells otherwise wherever they occur:
# dropout draws from an integer seed in place of a PRNG key
RENAMED = {"rng": "seed", "dropout_rng": "seed"}

INIT = ("a PRNG-key init: the numpy-seeded flat inits replace it "
        "(models/pretrain.init_flat_params, init_flat_v_encoder, "
        "models/tvc.init_flat_tvc_params and the VideoQA/VIOLIN inits)")
MESH = ("GSPMD mesh and sharding machinery: parallel/dist.py's process "
        "groups and the port's explicit collectives replace it")
PALLAS = ("selects the Pallas kernel or interpret mode: the port's wrapper "
          "takes the CUDA kernel on a card and the plain version on the CPU")
DROPOUT_CFG = ("the embedders take their dropout rate and seed, not the "
               "config, a train flag and a key")
UNCALLED = "no caller in either package passes it"
SEG = ("packed masks travel as int32 segment ids (-1 a pad slot), not a "
       "one-hot; kv_mask and seg select the attention's mode")

# "module:name" (a function or class), "module:Class.method" or
# "module:function(parameter)" -> why the port does not have it
ALLOWED: Dict[str, str] = {
    # JAX-only machinery
    "utils/misc.py:enable_fast_rng": "sets JAX's PRNG implementation",
    "utils/misc.py:params_to_device": "jax.device_put of a parameter tree; "
                                      "nn.tree_to in the port",
    "ops/attention.py:packed_attention(use_pallas)": PALLAS,
    "ops/attention.py:multi_head_attention(use_pallas)": PALLAS,
    "ops/layernorm.py:dropout_add_layer_norm(use_pallas)": PALLAS,
    "ops/layernorm.py:layer_norm(use_pallas)": PALLAS,
    "data/loader.py:PrefetchLoader.__init__(device_put)":
        "a jax.device_put callable; the port's thread places the batch on "
        "its ``device`` through pinned memory",
    "training/step.py:make_train_step(donate)":
        "jit buffer donation; the port's step is eager and out of place",
    "training/step.py:make_sharded_train_step": MESH,
    "training/step.py:shard_state(mesh)": MESH,
    "drivers/common.py:run_training(mesh)": MESH,
    "evaluation/vcmr_eval.py:embed_video_corpus(mesh)": MESH,
    "evaluation/vcmr_eval.py:validate_full_vcmr(mesh)": MESH,
    "parallel/mesh.py:init_distributed": "parallel/dist.init_distributed",
    "parallel/mesh.py:get_mesh": MESH,
    "parallel/mesh.py:batch_sharding": MESH,
    "parallel/mesh.py:replicated_sharding": MESH,
    "parallel/mesh.py:shard_batch": "dist.shard_rows cuts a rank's rows",
    "parallel/mesh.py:divisor_mesh": MESH,
    "parallel/mesh.py:shard_task_batch": "dist.shard_rows cuts a rank's "
                                         "rows",
    "parallel/mesh.py:is_primary": "parallel/dist.is_primary",
    "parallel/mesh.py:host_allgather": "parallel/dist.host_allgather",
    "parallel/mesh.py:get_seq_mesh": "dist.init_grid('seq', S)",
    "parallel/mesh.py:enable_seq_parallel": "parallel/dist."
                                            "enable_seq_parallel",
    "parallel/mesh.py:seq_constraint": MESH,
    "parallel/mesh.py:get_2d_mesh": "dist.init_grid('model', S)",
    "parallel/pipeline.py:get_pp_mesh": "dist.init_grid('stage', S)",
    "parallel/pipeline.py:driver_mesh": "pipeline.driver_grid",
    "parallel/pipeline.py:compatible": "a trace-time test of a batch's "
                                       "shard over the mesh; the port's "
                                       "pipeline splits what it is given",
    "parallel/pipeline.py:enable_pipeline(mesh)":
        "takes a flag; the grid (dist.init_grid) holds the stages",
    "parallel/pipeline.py:pipelined_encoder(layers_p)":
        "the stage's list of layers, ``layers``, not a stacked tree",
    "parallel/pipeline.py:pipelined_encoder(keys)":
        "layer i draws from the sub-seed layer{i} of ``seed``",
    "parallel/pipeline.py:pipelined_encoder(use_rng)":
        "dropout is on where ``seed`` is given",
    "parallel/pipeline.py:pipelined_encoder(mask)": SEG,
    # the init functions
    "models/nn.py:init_linear": INIT,
    "models/nn.py:init_embedding": INIT,
    "models/nn.py:init_layer_norm": INIT,
    "models/nn.py:init_mlp_layer": INIT,
    "models/nn.py:init_linear_layer": INIT,
    "models/embed.py:init_sub_embeddings": INIT,
    "models/embed.py:init_image_embeddings": INIT,
    "models/embed.py:init_frame_embeddings": INIT,
    "models/embed.py:init_query_feat_embeddings": INIT,
    "models/encoder.py:init_cross_modal_trm": INIT,
    "models/encoder.py:init_temporal_trm": INIT,
    "models/encoder.py:init_query_feat_encoder": INIT,
    "models/model.py:init_hierarchical_vl_model": INIT,
    "models/pretrain.py:init_pretrain_head": INIT,
    "models/pretrain.py:init_hero_for_pretraining": INIT,
    "models/transformer.py:init_attention": INIT,
    "models/transformer.py:init_ffn": INIT,
    "models/transformer.py:init_encoder_layer": INIT,
    "models/transformer.py:init_encoder": INIT,
    "models/transformer.py:init_pooler": INIT,
    "models/transformer.py:init_lm_head": INIT,
    "models/transformer.py:init_decoder_layer": INIT,
    "models/transformer.py:init_decoder": INIT,
    "models/tvc.py:init_hero_for_tvc": INIT,
    # the same result by another road
    "models/embed.py:sub_embeddings(cfg)": DROPOUT_CFG,
    "models/embed.py:sub_embeddings(train)": DROPOUT_CFG,
    "models/embed.py:image_embeddings(cfg)": DROPOUT_CFG,
    "models/embed.py:image_embeddings(train)": DROPOUT_CFG,
    "models/embed.py:frame_embeddings(cfg)": DROPOUT_CFG,
    "models/embed.py:frame_embeddings(train)": DROPOUT_CFG,
    "models/embed.py:query_feat_embeddings(cfg)": DROPOUT_CFG,
    "models/embed.py:query_feat_embeddings(train)": DROPOUT_CFG,
    "models/embed.py:sub_embeddings(token_type_ids)":
        "no caller passes one: every text slot takes type id 1 (the "
        "default of both packages)",
    "models/embed.py:image_embeddings(projected)":
        "pre-projected frames come only from the JAX clip-level "
        "projection (model.PROJECT_CLIP_LEVEL, off); the port projects "
        "the frame slots here, as the JAX default does",
    "models/encoder.py:cross_modal_repr(v_feats_projected)":
        "as image_embeddings(projected)",
    "models/model.py:forward_repr(c_v_feats_override)":
        "no JAX caller passes it (default: the batch's c_v_feats)",
    "models/model.py:forward_repr(f_img_masks)":
        "no JAX caller passes it; forward_mfm masks its frame slots "
        "itself in both packages",
    "models/encoder.py:cross_modal_mlm(vocab_pad)":
        "no JAX caller passes it (default 0: no logit columns cut)",
    "models/encoder.py:query_feat_encoder_packed(seg_onehot)": SEG,
    "models/transformer.py:encoder(mask)": SEG,
    "evaluation/vcmr_eval.py:embed_video_corpus(max_clip_len)":
        "unused by the JAX function: the frame axis is the batches' own",
    "evaluation/vcmr_eval.py:make_query_scorer(mod_query_input)":
        "packed queries have a scorer of their own "
        "(make_fused_packed_scorer)",
    "drivers/common.py:load_checkpoint_into(params)":
        "the port's init trees are flat JAX-layout dicts (``flat``), not "
        "nested ones",
    "training/optim.py:adamw_update(decay_mask)":
        "the decay rule is read from each leaf's path (optim.decays)",
    "training/optim.py:adamw_update(top_mask)":
        "the head rule is read from each leaf's path (optim.is_top)",
    "training/save.py:TrainingRestorer.step(global_step)":
        "read from the train state",
    "training/save.py:TrainingRestorer.save(global_step)":
        "read from the train state",
    "training/save.py:TrainingRestorer.restore(train_state)":
        "builds the state from the file on the ``device`` given; no "
        "template state",
    # options no caller in either package passes
    "data/loader.py:PrefetchLoader.__init__(depth)": UNCALLED,
    "drivers/common.py:run_training(log_every)":
        UNCALLED + " (the loop logs every LOG_EVERY steps)",
    "models/transformer.py:encoder(remat)":
        UNCALLED + "; transformer.set_remat turns remat on for every call",
    "models/transformer.py:decoder(self_mask)": UNCALLED,
    "models/tvc.py:decode(pos_ids)": UNCALLED + " (positions 0..Lt-1)",
    "data/downstream_tasks.py:ViolinDataset.__init__(paired)":
        UNCALLED + " (every item is a statement pair)",
    "utils/logger.py:RunningMeter.__init__(val)": UNCALLED,
    "utils/logger.py:RunningMeter.__init__(smooth)":
        UNCALLED + " (RunningMeter.SMOOTH, 0.99)",
    "utils/logger.py:ScalarWriter.log_scalar_dict(prefix)": UNCALLED,
}


def _params(fn: ast.FunctionDef) -> List[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _public(name: str) -> bool:
    return not name.startswith("_") or name == "__init__"


def api(path: pathlib.Path) -> Dict[str, Tuple[str, object]]:
    """{name: ("def", [params]) or ("class", {method: [params]})} of the
    public top-level functions and classes of a module."""
    out: Dict[str, Tuple[str, object]] = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and not node.name.startswith("_"):
            out[node.name] = ("def", _params(node))
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = ("class", {
                b.name: _params(b) for b in node.body
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                and _public(b.name)})
    return out


def flags(path: pathlib.Path) -> Set[str]:
    """The ``--flags`` of every ``add_argument`` call of a module."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", None) == "add_argument":
            out |= {a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and a.value.startswith("-")}
    return out


def port_flags(path: pathlib.Path) -> Set[str]:
    """A port module's flags and those of the port modules it imports
    from (a shared parser)."""
    out = flags(path)
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("hero_tpu_torch."):
            dep = PORT.joinpath(*node.module.split(".")[1:])
            dep = dep.with_suffix(".py") if dep.with_suffix(".py").exists() \
                else dep / "__init__.py"
            if dep.exists():
                out |= flags(dep)
    return out


def _missing_params(mod, where, jax_params, port_params) -> List[str]:
    return [f"{mod}:{where}({p})" for p in jax_params
            if p not in port_params
            and RENAMED.get(p) not in port_params]


def gaps(mod: str, jax_api, port_api) -> List[str]:
    """Every JAX name of ``mod`` the port lacks, in :data:`ALLOWED`'s
    notation."""
    out = []
    for name, (kind, sig) in jax_api.items():
        if name not in port_api or port_api[name][0] != kind:
            out.append(f"{mod}:{name}")
        elif kind == "def":
            out += _missing_params(mod, name, sig, port_api[name][1])
        else:
            methods = port_api[name][1]
            for meth, ps in sig.items():
                if meth not in methods:
                    out.append(f"{mod}:{name}.{meth}")
                else:
                    out += _missing_params(mod, f"{name}.{meth}", ps,
                                           methods[meth])
    return out


MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("mod", MODULES)
def test_port_has_the_jax_api(mod):
    """``hero_tpu_torch/<mod>`` exists and holds every public function,
    class, method, parameter and flag of ``hero_tpu/<mod>`` but the
    allowed ones."""
    port = PORT / mod
    assert port.exists(), f"hero_tpu_torch/{mod} is missing"
    found = [g for g in gaps(mod, api(JAX / mod), api(port))
             if g not in ALLOWED]
    assert not found, f"the port lacks {found}"
    lost = sorted(flags(JAX / mod) - port_flags(port))
    assert not lost, f"hero_tpu_torch/{mod} lacks the flags {lost}"


def test_every_allowed_entry_is_a_gap_with_a_reason():
    """Each entry names something of the JAX package that the port does
    not have (an entry the port caught up with must go), and gives a
    one-line reason."""
    live = {g for mod in MODULES if (PORT / mod).exists()
            for g in gaps(mod, api(JAX / mod), api(PORT / mod))}
    stale = sorted(set(ALLOWED) - live)
    assert not stale, f"no longer gaps: {stale}"
    for entry, reason in ALLOWED.items():
        assert reason.strip() and "\n" not in reason, entry


def test_removing_a_ported_name_is_caught():
    """The check itself: in each module, dropping any one ported public
    function or class, method or parameter from the port's API makes a
    gap that :data:`ALLOWED` does not excuse."""
    checked = 0
    for mod in MODULES:
        jax_api, port_api = api(JAX / mod), api(PORT / mod)
        for name, (kind, sig) in jax_api.items():
            if f"{mod}:{name}" in ALLOWED:
                continue
            cut = {k: v for k, v in port_api.items() if k != name}
            assert set(gaps(mod, jax_api, cut)) - set(ALLOWED), name
            checked += 1
            if kind == "def" and sig and name in port_api:
                ported = [p for p in sig if p in port_api[name][1]]
                if ported:
                    cut = dict(port_api)
                    cut[name] = ("def", [p for p in port_api[name][1]
                                         if p != ported[-1]])
                    assert set(gaps(mod, jax_api, cut)) - set(ALLOWED), \
                        (name, ported[-1])
    assert checked > 300
