"""LLM prompt templates for detection, planning, reflection, comparison
(the port's copy of ``image_restoration_agent_tpu/agent/prompts.py``).

Functionally equivalent to the reference's seven templates
(AgenticIR/pipeline/prompts.py:1-64): same decision points, same structured
output contracts (JSON fields, severity vocabulary, permutation constraint),
re-worded for this framework. The *format contracts* are what the agent's
format-check retry loop validates — they must stay exact.
"""

SEVERITIES = ["very low", "low", "medium", "high", "very high"]

SYSTEM_MESSAGE = (
    "You are an image-restoration planning expert. The user has a degraded "
    "image that may suffer from any mix of eight degradations: low "
    "resolution, noise, motion blur, defocus blur, haze, rain, dark, and "
    "jpeg compression artifact. Dedicated tools exist for each: "
    "super-resolution, denoising, motion deblurring, defocus deblurring, "
    "dehazing, deraining, brightening, and jpeg compression artifact "
    "removal. You will be asked to assess degradations, order restoration "
    "tasks, and judge results. Whenever an output format is specified, "
    "reply in exactly that format with nothing else."
)

EVALUATE_DEGRADATION = (
    "Assess this image for the following seven degradations: noise, motion "
    "blur, defocus blur, haze, rain, dark, and jpeg compression artifact. "
    "For every degradation give your reasoning and a severity rating. "
    'Reply with a JSON list of objects, each with exactly the fields '
    '"degradation", "thought", and "severity". "degradation" must be one '
    'of ["noise", "motion blur", "defocus blur", "haze", "rain", "dark", '
    '"jpeg compression artifact"]; "severity" must be one of "very low", '
    '"low", "medium", "high", "very high".'
)

EVALUATE_SINGLE_DEGRADATION = (
    "How severe is the {degradation} in this image? Answer with exactly one "
    "of: very low, low, medium, high, very high."
)

DISTILL_KNOWLEDGE = (
    "We restore images that suffer from several degradations at once "
    "(low-resolution, noise, motion blur, defocus blur, rain, haze, dark, "
    "jpeg compression artifact) by running dedicated tools "
    "(super-resolution, denoising, motion deblurring, defocus deblurring, "
    "deraining, dehazing, brightening, jpeg compression artifact removal) "
    "in some order. The order matters: tasks interact through their "
    "side-effects and preconditions. We ran controlled trials and gathered "
    "this experience:\n{experience}\n"
    "Distill general, transferable rules for choosing task order from this "
    "experience. Expect unseen, more complex degradation mixes later."
)

SCHEDULE_WITH_EXPERIENCE = (
    "An image suffers from these degradations: {degradations}. We will run "
    "one dedicated tool per degradation, i.e. these tasks: {agenda}. "
    "Decide the order to run them. Past trials produced this experience:\n"
    "{experience}\n"
    'Using that experience, reply with a JSON object with exactly two '
    'fields: "thought" (your reasoning) and "order" (the tasks as a list '
    "that must be a permutation of {agenda})."
)

REASON_ABOUT_ORDER = (
    "An image suffers from these degradations: {degradations}. We will run "
    "these restoration tasks: {agenda}. Explain what the right execution "
    "order would be, considering what each task needs from its input and "
    "what artifacts it can introduce."
)

SCHEDULE_WITHOUT_EXPERIENCE = (
    "An image suffers from {degradations}. We will run these restoration "
    "tasks: {agenda}. Relevant considerations:\n{insights}\n"
    "Reply with only a list of the tasks in execution order; it must be a "
    "permutation of {agenda}."
)

RESCHEDULE_POSTSCRIPT = (
    "\nNote: in the attempts so far, starting with {failed_tries} gave "
    "unsatisfactory results. Do not place {failed_tries} first."
)

EVALUATE_TOOL_RESULT = (
    "How severe is the {degradation} in this image? Give your reasoning. "
    'Reply with a JSON object with exactly two fields: "thought" and '
    '"severity", where "severity" is one of "very low", "low", "medium", '
    '"high", "very high".'
)

COMPARE_QUALITY = (
    "Which of these two images has better quality? Give your reasoning. "
    'Reply with a JSON object with exactly two fields: "thought" and '
    '"choice", where "choice" is "former" or "latter" — or "neither" if '
    "the difference is negligible."
)

COMPARE_QUALITY_SHORT = (
    "Which image, Image A or Image B, has better quality? Answer with a "
    "single word or phrase."
)
