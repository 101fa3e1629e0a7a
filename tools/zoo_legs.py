#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s model-zoo and f16 legs alone on one CUDA card,
from the repository root:

    python3 tools/zoo_legs.py [paged] [flash] [llama] [bert] [bert16] [vit] [t5] [ingest]

After ``phase_device`` and ``phase_build`` it runs the named legs (all of
them with no argument): ``[paged]`` (with its f16 cases), ``[flash]``
(with ``[flash d]``'s head dims, D 256 and 160 timed, and ``[flash
f32]``'s f32 and f16 rows), ``[hf llama]`` (with its f16 sibling), ``[hf bert f32]``, ``[bert f16]``, ``[vit]``, ``[t5]`` and
``[ingest]``, under ``chip_smoke.py``'s own gates, and prints ``[phase
seconds]``.
"""

import sys

sys.path.insert(0, ".")

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

LEGS = ("paged", "flash", "llama", "bert", "bert16", "vit", "t5", "ingest")


def main(legs) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, name_power = cs.timed("device", cs.phase_device)
    cs.timed("build", cs.phase_build)
    if "paged" in legs:
        cs.timed("paged", cs.phase_paged, cs.L2Flush())
    if "flash" in legs:
        cs.timed("flash", cs.phase_flash, cs.L2Flush())
    if "llama" in legs:
        prompts = cs._requests(cs.LlamaConfig.llama3_8b().vocab_size)
        cs.timed("hf llama", cs.phase_hf_llama, name_power, prompts)
    for leg, name, fn in (("bert", "hf bert f32", cs.phase_hf_bert_f32),
                          ("bert16", "bert f16", cs.phase_bert_f16),
                          ("vit", "vit", cs.phase_vit), ("t5", "t5", cs.phase_t5),
                          ("ingest", "ingest", cs.phase_ingest)):
        if leg in legs:
            cs.timed(name, fn, name_power)
    cs._phase_line()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or LEGS))
