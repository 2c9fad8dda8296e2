"""Bot registry of the port: Java class names and short names -> bots.

A copy of ``microrts_tpu.config``'s ``JAVA_AI_ALIASES`` (the reflective
instantiation analog of GameSettings/Game.java:44-50) and of ``make_bot``
for the bots the port has.  ``make_bot`` returns a
``bots.scripted.Opponent`` (the bot and the draw of the noise it reads),
or for the stateful bots (BS1/BS2/BS3_NaiveMCTS, ContinuingNaiveMCTS) a
``bots.believestate.StatefulBot``.  The learned models
(UnitActionProbabilityDistributionAI, InformedNaiveMCTS) read the shipped
AIM-WR model from the port's ``assets/bayesianmodels/``; CooperativeAI
plays fresh, seeded genomes (``bots.cooperative.default_genomes``).
A name the JAX package knows but the port has not ported raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

JAVA_AI_ALIASES = {
    "ai.abstraction.WorkerRush": "WorkerRush",
    "ai.abstraction.LightRush": "LightRush",
    "ai.abstraction.HeavyRush": "HeavyRush",
    "ai.abstraction.RangedRush": "RangedRush",
    "ai.RandomBiasedAI": "RandomBiasedAI",
    "ai.RandomAI": "RandomAI",
    "ai.PassiveAI": "PassiveAI",
    "ai.abstraction.partialobservability.POWorkerRush": "POWorkerRush",
    "ai.abstraction.partialobservability.POLightRush": "POLightRush",
    "ai.abstraction.partialobservability.POHeavyRush": "POHeavyRush",
    "ai.abstraction.partialobservability.PORangedRush": "PORangedRush",
    "ai.montecarlo.MonteCarlo": "MonteCarlo",
    "ai.mcts.naivemcts.NaiveMCTS": "NaiveMCTS",
    "ai.mcts.uct.UCT": "UCT",
    "ai.mcts.uct.DownsamplingUCT": "DownsamplingUCT",
    "ai.mcts.informedmcts.InformedNaiveMCTS": "InformedNaiveMCTS",
    "ai.mcts.mlps.MLPSMCTS": "MLPSMCTS",
    "ai.mcts.naivemcts.TwoPhaseNaiveMCTS": "TwoPhaseNaiveMCTS",
    "ai.mcts.uct.UCTFirstPlayUrgency": "UCTFirstPlayUrgency",
    "ai.mcts.uct.UCTUnitActions": "UCTUnitActions",
    "ai.RandomBiasedSingleUnitAI": "RandomBiasedSingleUnitAI",
    "ai.stochastic.UnitActionProbabilityDistributionAI":
        "UnitActionProbabilityDistributionAI",
    "ai.montecarlo.lsi.LSI": "LSI",
    "ai.puppet.PuppetSearchAB": "PuppetSearchAB",
    "ai.puppet.PuppetSearchMCTS": "PuppetSearchMCTS",
    "ai.puppet.PuppetNoPlan": "PuppetNoPlan",
    "ai.scv.SCV": "SCV",
    "ai.ahtn.AHTNAI": "AHTN",
    "ai.mcts.believestatemcts.BS1_NaiveMCTS": "BS1_NaiveMCTS",
    "ai.mcts.believestatemcts.BS2_NaiveMCTS": "BS2_NaiveMCTS",
    "ai.mcts.believestatemcts.BS3_NaiveMCTS": "BS3_NaiveMCTS",
    "ai.minimax.ABCD.ABCD": "ABCD",
    "ai.minimax.ABCD.IDABCD": "IDABCD",
    "ai.minimax.RTMiniMax.RTMinimax": "RTMinimax",
    "ai.minimax.RTMiniMax.IDRTMinimax": "IDRTMinimax",
    "ai.portfolio.PortfolioAI": "PortfolioAI",
    "ai.portfolio.portfoliogreedysearch.PGSAI": "PGSAI",
    "ai.abstraction.WorkerDefense": "WorkerDefense",
    "ai.abstraction.LightDefense": "LightDefense",
    "ai.abstraction.HeavyDefense": "HeavyDefense",
    "ai.abstraction.RangedDefense": "RangedDefense",
    "ai.abstraction.WorkerRushPlusPlus": "WorkerRushPlusPlus",
    "ai.abstraction.EconomyRush": "EconomyRush",
    "ai.abstraction.EconomyMilitaryRush": "EconomyMilitaryRush",
    "ai.abstraction.EMRDeterministico": "EMRDeterministico",
    "ai.abstraction.EconomyRushBurster": "EconomyRushBurster",
    "ai.abstraction.SimpleEconomyRush": "SimpleEconomyRush",
    "ai.abstraction.cRush.CRush_V1": "CRush_V1",
    "ai.abstraction.cRush.CRush_V2": "CRush_V2",
}

# the scripted rushes the port has: name -> bots.scripted constructor
_RUSH = dict(
    WorkerRush="worker_rush", LightRush="light_rush", HeavyRush="heavy_rush",
    RangedRush="ranged_rush", WorkerDefense="worker_defense",
    LightDefense="light_defense", HeavyDefense="heavy_defense",
    RangedDefense="ranged_defense", WorkerRushPlusPlus="worker_rush_plus_plus",
    EconomyRush="economy_rush", EconomyMilitaryRush="economy_military_rush",
    EMRDeterministico="emr_deterministico",
    EconomyRushBurster="economy_rush_burster",
    SimpleEconomyRush="simple_economy_rush", CRush_V1="crush_v1",
    CRush_V2="crush_v2")
RUSH_BOTS = tuple(_RUSH)
# the partially observable rushes: name -> bots.scripted constructor
_PO_RUSH = dict(POWorkerRush="po_worker_rush", POLightRush="po_light_rush",
                POHeavyRush="po_heavy_rush", PORangedRush="po_ranged_rush")
PO_BOTS = tuple(_PO_RUSH)
SEARCH_BOTS = ("MonteCarlo",)
# the tree-search bots the port has: name -> (bots.treesearch constructor,
# its arguments), as the JAX package's registry builds them
# (microrts_tpu/config.py:222-237)
_TREE = dict(
    NaiveMCTS=("naive_mcts_bot", {}),
    TwoPhaseNaiveMCTS=("naive_mcts_bot", dict(
        eps0=1.0, eps_l=0.3, eps_g=0.0, phase2=(0.0, 0.3, 0.0),
        phase1_ratio=0.5)),
    MLPSMCTS=("mlps_mcts_bot", {}),
    UCTUnitActions=("uct_unit_actions_bot", {}),
    UCT=("uct_tree_bot", {}),
    DownsamplingUCT=("uct_tree_bot", dict(n_candidates=4)),
    UCTFirstPlayUrgency=("uct_tree_bot", dict(fpu=0.5)))
TREE_BOTS = tuple(_TREE)
# the minimax family: name -> bots.minimax constructor, with the JAX
# package's registry arguments (microrts_tpu/config.py:239-250: the
# defaults)
_MINIMAX = dict(
    ABCD="abcd_bot", SampledABCD="sampled_abcd_bot", IDABCD="id_abcd_bot",
    RTMinimax="rt_minimax_bot", IDRTMinimax="idrt_minimax_bot",
    IDRTMinimaxRandomized="idrt_minimax_randomized_bot")
MINIMAX_BOTS = tuple(_MINIMAX)
# the stateful bots (microrts_tpu/config.py:212-225): the believe-state
# levels around the default NaiveMCTS, and tree reuse
_BELIEVE = dict(BS1_NaiveMCTS=1, BS2_NaiveMCTS=2, BS3_NaiveMCTS=3)
STATEFUL_BOTS = tuple(_BELIEVE) + ("ContinuingNaiveMCTS",)
# the learned models (microrts_tpu/config.py:133-155, :230-251)
LEARNED_BOTS = ("UnitActionProbabilityDistributionAI", "InformedNaiveMCTS",
                "CooperativeAI")
PORTED_BOTS = ("PassiveAI", "RandomAI", "RandomBiasedAI",
               "RandomBiasedSingleUnitAI") + RUSH_BOTS \
    + PO_BOTS + SEARCH_BOTS + TREE_BOTS + MINIMAX_BOTS + STATEFUL_BOTS \
    + LEARNED_BOTS

# names the JAX package has and the port not yet: the ROADMAP.md queue 1
# item that ports them
_NOT_PORTED = {n: "item 10 (search bots)" for n in (
    "SCV", "SCVAdaptive", "AHTN", "LSI", "PuppetNoPlan", "PuppetSearchMCTS",
    "PuppetSearchAB", "PortfolioAI", "PGSAI")}


def pretrained_wr() -> str:
    """The AIM-WR pretrained Bayes model (the Java InformedNaiveMCTS
    default, InformedNaiveMCTS.java:72-84), shipped in the port's
    assets."""
    from .utils.assets import asset_path
    return asset_path("bayesianmodels/ActionInterdependenceModel-WR.xml")


def make_bot(name: str, env):
    """Bot by (Java or short) name, as a ``bots.scripted.Opponent`` (a
    ``bots.believestate.StatefulBot`` for ``STATEFUL_BOTS``)."""
    from .bots import scripted as S

    name = JAVA_AI_ALIASES.get(name, name)
    if name == "PassiveAI":
        return S.passive_opponent(env)
    if name == "RandomAI":
        return S.random_opponent(env, 1.0)
    if name == "RandomBiasedAI":
        return S.random_opponent(env, 5.0)
    if name == "RandomBiasedSingleUnitAI":
        return S.single_unit_opponent(env, 5.0)
    if name in _RUSH:
        return S.Opponent(getattr(S, _RUSH[name])(env))
    if name in _PO_RUSH:
        return S.Opponent(getattr(S, _PO_RUSH[name])(env))
    if name == "MonteCarlo":
        from .bots.search import monte_carlo_bot
        return monte_carlo_bot(env)
    if name in _TREE:
        from .bots import treesearch as TS
        fn, kw = _TREE[name]
        return getattr(TS, fn)(env, **kw)
    if name in _MINIMAX:
        from .bots import minimax as MM
        return getattr(MM, _MINIMAX[name])(env)
    if name in _BELIEVE:
        from .bots import believestate as BS
        from .bots import treesearch as TS
        return BS.believe_state_bot(env, TS.naive_mcts_bot(env),
                                    level=_BELIEVE[name])
    if name == "ContinuingNaiveMCTS":
        from .bots import treesearch as TS
        return TS.naive_mcts_continuing(env)
    if name == "UnitActionProbabilityDistributionAI":
        from .ml.pretrained import pretrained_bayes_bot
        return pretrained_bayes_bot(env, pretrained_wr())
    if name == "InformedNaiveMCTS":
        from .bots import treesearch as TS
        return TS.informed_naive_mcts_bot(env, pretrained_wr())
    if name == "CooperativeAI":
        from .bots.cooperative import cooperative_bot
        return cooperative_bot(env)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet: ROADMAP.md queue 1 "
            f"{_NOT_PORTED[name]}")
    raise ValueError(f"unknown AI {name!r}; available: "
                     f"{sorted(PORTED_BOTS)}")
