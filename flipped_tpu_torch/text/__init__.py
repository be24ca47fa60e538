"""Host-side text layer: the port's own copies of flipped_tpu.text
(tokenizers, prompt encoders, label masking), numpy only."""
from .tokenizer import (A_TOKEN_ID, NL_ID, Q_TOKEN_ID, V_TOKEN_ID,
                        MockTokenizer, PurePythonSentencePieceTokenizer,
                        SentencePieceTokenizer, TokenizerLike, load_tokenizer)
from .prompts import (PromptText, VIDEO_PLACEHOLDER, encode_dqav, encode_dvaq,
                      encode_dvqa, encode_qav, encode_vaq, encode_vqa)
from .masking import (OBJECTIVES, TextFeatures, build_dialogue_text_features,
                      build_text_features, lm_labels, pad_ids,
                      pad_ids_dialogue, qav_labels, sanitize_text_id)

__all__ = [
    "A_TOKEN_ID", "NL_ID", "Q_TOKEN_ID", "V_TOKEN_ID", "MockTokenizer",
    "PurePythonSentencePieceTokenizer", "SentencePieceTokenizer",
    "TokenizerLike", "load_tokenizer", "PromptText",
    "VIDEO_PLACEHOLDER", "encode_dqav", "encode_dvaq", "encode_dvqa",
    "encode_qav", "encode_vaq", "encode_vqa", "OBJECTIVES", "TextFeatures",
    "build_dialogue_text_features", "build_text_features", "lm_labels",
    "pad_ids", "pad_ids_dialogue", "qav_labels", "sanitize_text_id",
]
