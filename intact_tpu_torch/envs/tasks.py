"""Simpler Bridge intention-probing task suites — the heart of INT-ACT (a copy
of intact_tpu/envs/tasks.py).

Single source of truth for the ~51 WidowX Bridge task variants the paper
evaluates (reference `config/experiment/simpler/pi0_finetune_bridge_ev.yaml:6-77`),
organized by probe axis:

  ORIGINAL        the 4 trained Bridge tasks
  DISTRACTION     extra objects on the table (intention vs execution split)
  UNSEEN_COMBO    seen source+target objects, unseen pairing (+ ood objects)
  LANGUAGE        instruction perturbations (common-name, action-verb,
                  negation, color/shape references), some with distractors
  EXTENDED        later additions (orange juice / nut / ramekin / wheel)

Experiment YAMLs under config/experiment/simpler/ are generated from the JAX
package's lists by scripts/gen_experiment_configs.py; keep the two equal.
"""

from __future__ import annotations

ORIGINAL = [
    "widowx_spoon_on_towel",
    "widowx_carrot_on_plate",
    "widowx_stack_cube",
    "widowx_put_eggplant_in_basket",
]

DISTRACTION = [
    "widowx_spoon_on_towel_distract",
    "widowx_carrot_on_plate_distract",
    "widowx_carrot_on_keyboard_distract",
    "widowx_coke_can_on_plate_distract",
    "widowx_coke_can_on_keyboard_distract",
]

# seen source and target objects in unseen combinations, plus ood source
# (coke can / pepsi) and ood target (keyboard) probes
UNSEEN_COMBO = [
    "widowx_cube_on_plate_clean",
    "widowx_small_plate_on_green_cube_clean",
    "widowx_coke_can_on_plate_clean",
    "widowx_pepsi_on_plate_clean",
    "widowx_carrot_on_sponge_clean",
    "widowx_eggplant_on_sponge_clean",
    "widowx_carrot_on_keyboard_clean",
    "widowx_coke_can_on_keyboard_clean",
]

# language perturbation: first 8 = "lang1" sweep, second 8 = "lang2" sweep
LANGUAGE_1 = [
    "widowx_carrot_on_plate_lang_common",
    "widowx_carrot_on_plate_lang_action",
    "widowx_carrot_on_plate_lang_neg",
    "widowx_carrot_on_plate_lang_neg_action",
    "widowx_carrot_on_plate_lang_common_distract",
    "widowx_spoon_on_towel_lang_action",
    "widowx_spoon_on_towel_lang_common",
    "widowx_spoon_on_towel_lang_common_distract",
]

LANGUAGE_2 = [
    "widowx_stack_cube_lang_action",
    "widowx_eggplant_in_basket_lang_action",
    "widowx_eggplant_in_basket_lang_color",
    "widowx_eggplant_in_basket_lang_common",
    "widowx_carrot_on_keyboard_lang_common",
    "widowx_coke_can_on_plate_lang_common",
    "widowx_coke_can_on_plate_lang_neg",
    "widowx_coke_can_on_plate_lang_common_distract",
]

EXTENDED = [
    "widowx_orange_juice_on_plate_clean",
    "widowx_orange_juice_on_plate_distract",
    "widowx_orange_juice_on_plate_lang_neg",
    "widowx_orange_juice_on_plate_lang_common",
    "widowx_orange_juice_on_plate_lang_common_distract",
    "widowx_orange_juice_on_plate_lang_common_distractv2",
    "widowx_nut_on_plate_clean",
    "widowx_nut_on_plate_lang_common",
    "widowx_eggplant_on_keyboard_clean",
    "widowx_carrot_on_ramekin_clean",
    "widowx_carrot_on_wheel_clean",
    "widowx_coke_can_on_ramekin_clean",
    "widowx_coke_can_on_wheel_clean",
    "widowx_nut_on_wheel_clean",
    "widowx_cube_on_plate_lang_shape",
    "widowx_spoon_on_towel_lang_neg",
    "widowx_spoon_on_towel_lang_color",
    "widowx_carrot_on_plate_lang_color",
]

FULL_SUITE = (
    ORIGINAL + DISTRACTION + UNSEEN_COMBO + LANGUAGE_1 + LANGUAGE_2 + EXTENDED
)

# the freezevlm / paraphrase / rephrase-ft sweeps drop lang_neg_action
FULL_SUITE_50 = [t for t in FULL_SUITE if t != "widowx_carrot_on_plate_lang_neg_action"]

SUITES: dict[str, list[str]] = {
    "full": FULL_SUITE,
    "full50": FULL_SUITE_50,
    "original": ORIGINAL,
    "distraction": DISTRACTION,
    "ood": UNSEEN_COMBO,
    "lang1": LANGUAGE_1,
    "lang2": LANGUAGE_2,
    "extended": EXTENDED,
}


def get_suite(name: str) -> list[str]:
    if name not in SUITES:
        raise KeyError(f"unknown task suite {name!r} (available: {sorted(SUITES)})")
    return list(SUITES[name])
