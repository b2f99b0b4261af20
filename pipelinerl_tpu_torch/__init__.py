"""PyTorch + CUDA port of pipelinerl_tpu for NVIDIA Hopper (sm_90a).

The serving path (the slab continuous-batching engine, the model, sampling,
the in-process client) and the training path (``rl_loss``, the
``TrainerLoop``, the preprocessor, the actor and the inline RL loop of
``launch.py``), with hand-written decode-attention and GQA flash-attention
forward and backward kernels (``csrc/``). It imports nothing of the JAX
package.
"""
