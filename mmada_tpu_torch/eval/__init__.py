"""Evaluation on the card: CLIP score and ImageReward for t2i
(`clip`, `image_reward`, `image_quality`), the T2M evaluators and metrics
for t2m and the motion VQ-VAE (`t2m_evaluator`, `t2m_metrics`,
`components`, `t2m_eval`), and the SMPL fit (`smpl_fit`). The numpy
modules (`motion_math`, `t2m_metrics`, `word_vectorizer`, `visualize`,
`mesh_render`) equal the JAX package's bit for bit; the models are plain
torch in fp32, in the JAX package's order of operations.
"""
