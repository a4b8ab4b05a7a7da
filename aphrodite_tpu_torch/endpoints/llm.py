"""Offline batch inference: the `LLM` class of the PyTorch port (the
JAX package's, driving the port's `AphroditeEngine.step()`). It runs on
the CUDA card unless the caller passes `device="cpu"`."""
from __future__ import annotations

from typing import List, Optional, Union

from aphrodite_tpu_torch.common.outputs import RequestOutput
from aphrodite_tpu_torch.common.sampling_params import SamplingParams
from aphrodite_tpu_torch.common.utils import Counter
from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
from aphrodite_tpu_torch.engine.args_tools import EngineArgs


class LLM:
    """Offline LLM for batch generation.

    Args mirror the reference LLM constructor; extra engine flags pass
    through **kwargs to EngineArgs.
    """

    def __init__(
        self,
        model: str,
        tokenizer: Optional[str] = None,
        tokenizer_mode: str = "auto",
        trust_remote_code: bool = False,
        tensor_parallel_size: int = 1,
        dtype: str = "auto",
        quantization: Optional[str] = None,
        revision: Optional[str] = None,
        tokenizer_revision: Optional[str] = None,
        seed: int = 0,
        gpu_memory_utilization: float = 0.9,
        swap_space: float = 4,
        enforce_eager: bool = False,
        max_context_len_to_capture: int = 8192,
        **kwargs,
    ) -> None:
        if "disable_log_stats" not in kwargs:
            kwargs["disable_log_stats"] = True
        engine_args = EngineArgs(
            model=model,
            tokenizer=tokenizer,
            tokenizer_mode=tokenizer_mode,
            trust_remote_code=trust_remote_code,
            tensor_parallel_size=tensor_parallel_size,
            dtype=dtype,
            quantization=quantization,
            revision=revision,
            tokenizer_revision=tokenizer_revision,
            seed=seed,
            gpu_memory_utilization=gpu_memory_utilization,
            swap_space=swap_space,
            enforce_eager=enforce_eager,
            max_context_len_to_capture=max_context_len_to_capture,
            **kwargs,
        )
        self.engine = AphroditeEngine.from_engine_args(engine_args)
        self.request_counter = Counter()

    def get_tokenizer(self):
        return self.engine.tokenizer.tokenizer

    def generate(
        self,
        prompts: Optional[Union[str, List[str]]] = None,
        sampling_params: Optional[SamplingParams] = None,
        prompt_token_ids: Optional[List[List[int]]] = None,
        prefix_pos: Optional[Union[int, List[int]]] = None,
        use_tqdm: bool = False,
        lora_request=None,
    ) -> List[RequestOutput]:
        """Generate completions for the prompts, batched through the
        continuous-batching engine (reference generate :118-178)."""
        if prompts is None and prompt_token_ids is None:
            raise ValueError("Either prompts or prompt_token_ids must be "
                             "provided.")
        if isinstance(prompts, str):
            prompts = [prompts]
        if (prompts is not None and prompt_token_ids is not None
                and len(prompts) != len(prompt_token_ids)):
            raise ValueError("The lengths of prompts and prompt_token_ids "
                             "must be the same.")
        if sampling_params is None:
            sampling_params = SamplingParams()

        num_requests = len(prompts) if prompts is not None else \
            len(prompt_token_ids)
        for i in range(num_requests):
            prompt = prompts[i] if prompts is not None else None
            token_ids = None if prompt_token_ids is None else \
                prompt_token_ids[i]
            pos = prefix_pos[i] if isinstance(prefix_pos, list) else \
                prefix_pos
            self._add_request(prompt, sampling_params, token_ids, pos,
                              lora_request)
        return self._run_engine(use_tqdm)

    def _add_request(self, prompt, sampling_params, prompt_token_ids,
                     prefix_pos, lora_request=None) -> None:
        request_id = str(next(self.request_counter))
        self.engine.add_request(request_id, prompt, sampling_params,
                                prompt_token_ids, prefix_pos=prefix_pos,
                                lora_request=lora_request)

    def _run_engine(self, use_tqdm: bool) -> List[RequestOutput]:
        pbar = None
        if use_tqdm:
            from tqdm import tqdm
            pbar = tqdm(total=self.engine.get_num_unfinished_requests(),
                        desc="Processed prompts")
        outputs: List[RequestOutput] = []
        while self.engine.has_unfinished_requests():
            step_outputs = self.engine.step()
            for out in step_outputs:
                if out.finished:
                    outputs.append(out)
                    if pbar is not None:
                        pbar.update(1)
        if pbar is not None:
            pbar.close()
        # Restore submission order (engine may finish out of order).
        outputs = sorted(outputs, key=lambda x: int(x.request_id))
        return outputs
